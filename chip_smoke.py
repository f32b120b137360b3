"""Drive the PyTorch/CUDA port (daclip_torch) on one NVIDIA GPU and check it.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing JSON lines:
  0 device   the card (nvidia-smi name and power limit), torch and CUDA versions,
             and whether matplotlib, sklearn and scipy import (their versions)
  1 build    nvcc builds daclip_torch/csrc/*.cu (one process per source); no
             instantiation of the linear-attention kernels, the bf16 dual 1×1
             or the bf16 3×3 conv may spill, nor a bf16 flash kernel at
             dim_head 32
 1b native_io  the host's image decoder (daclip_torch/native/dio.cc, built
             here with g++ on zlib): PNG (every row filter, 1/2/4/8-bit gray,
             palette, RGB, Adam7) and baseline JPEG (cv2 and PIL files at
             qualities 30-100, 4:4:4, 4:2:2, 4:2:0, 4:4:0, gray, restarts,
             optimised tables) at 1 × 1 to 512², whole and in six windows,
             against cv2.imdecode(IMREAD_UNCHANGED) then crop, bit for bit;
             decode_batch at 1 and 8 threads against them; files outside its
             set raise and read_img reads them as cv2 does. Times: a 288 ×
             320 Paeth and Average PNG (native, png.decode, png.py's plain
             rows, cv2), a 512² JPEG whole and as a 256² window against cv2,
             decode_batch images/s at 1 and 8 threads, and the Paeth PNG's
             256² window on 8 threads, decode_batch against png.decode on a
             Python thread pool
  2 kernels  each kernel against its plain PyTorch version at every shape the
             restore path gives it (the wrap also on inputs where the
             attention is as large as the bias, at each shape), the flash
             forward also at the training step's shapes and at its tile edges
             (N under one box, odd B, H and N, dim_head 64) keeping its lse
             (held against torch.logsumexp), the wrap also at the widths a
             multiple of 16 past the production UNet's (C = 16 to 80, bf16
             and f32, untimed); the wrap and flash called twice (the bytes
             must repeat);
             times (median of CUDA-event timed calls after warm-up, and the
             device time: CUDA events around ten calls queued behind a
             torch.cuda._sleep that outlasts their enqueue, so the span holds
             no host gap; torch.profiler only names the kernels), the bound,
             and for flash the one-call PyTorch yardstick
             (scaled_dot_product_attention, timed here only, event and device),
             the device time over the yardstick's, the exponentials' floor
             (B·H·N² at 3.9e12 a second) and each bf16 kernel's registers and
             shared memory; a device time at or under its bound fails the run
  2b kernels_alt  the kernels of the UNet's other wirings, each against its
             plain version: linear_attention_fused (v4), attn_wrap_fused (v3,
             with and without prenorm/residual) at the six sites on
             production-like and balanced inputs plus a ragged and an f32
             case and the widths of phase 2 (untimed); the attention core linear_attention at the six sites (its
             path: one call at each, counted), each linear-attention kernel
             called twice (the bytes must repeat); dual_conv1x1 at the four
             res_conv shapes of the nine sites, both forms, plus ragged and
             f32 cases and five at the bf16 kernel's tile edges, each called
             twice (the bytes must repeat), with torch.matmul as the single
             form's yardstick (event and device); then linear_attention_fused
             and dual_conv1x1's single form at the (v4, pointwise) training
             step's shapes (B=16)
  2c kernels_conv  conv3x3 against its plain version at the 15 shapes of the
             production UNet's 44 3×3 stride-1 convs at 256² (B=1), the three
             largest at B=16, a ragged and an f32 case and four at the bf16
             kernel's tile edges (its path: one call at each, counted), each
             called twice (the bytes must repeat), with cuDNN's conv2d on the
             channels_last view as the yardstick (timed here only); then both
             device times summed over the 44 sites
  3 fixture  the committed golden fixture replayed through the kernels in f32,
             in the default wiring and in (v4, pointwise) and (v3, pointwise)
 3b orbax    daclip_tpu's orbax train dirs (tests/fixtures/orbax, written by
             its train_restoration and train_daclip CLIs) read with no JAX on
             the machine: the zstd decoder built with g++ from
             daclip_torch/native/zstd.cc, every leaf of both latest trees
             against the SHA-256 daclip_tpu's restore_checkpoint gave, both
             dirs loaded through DACLIPRestorer.load (host ms), the LQ
             restored in f32 in the default (v5) wiring through the kernels
             with daclip_tpu's noise bank, > 40 dB against daclip_tpu's
             stored restore, exactly T launches of #1 a LinearAttention and
             of #2 a SpatialTransformer on that path (orbax); the decoder's
             MB/s (decoded bytes, median of 100) on the fixture's largest
             chunk
  4 serve    the production restore path at full width (ViT-B-32 DaCLIP, UNet
             nf=64 ch_mult 1,2,4,8, context 512, bf16, 100 posterior steps) on
             seeded random weights: four requests through DACLIPRestorer (the
             first through serve/predictor.py from a PNG file to a PNG file),
             with the kernels' launch counts per request
  4b serve_alt  the same weights in (v4, pointwise), (v3, pointwise) and (v5,
             pointwise): one full-width bf16 UNet forward each against the v5
             wiring's (limit: 3× the v5 bf16 forward's own distance from its
             f32 forward), then two 256² requests each with their launch
             counts and a UNet forward profile each; two v5 requests before
             and two after the other wirings are the yardstick in the phase
  4c forward_conv  one full-width bf16 v5 UNet forward with the output of
             each of its 44 3×3 stride-1 Conv2d replaced by conv3x3's (forward
             hooks registered here, not by the package): each site against
             the module's own output, exactly 44 launches, the forward against
             serve_alt's plain one (limit: 3× the v5 bf16 forward's distance
             from its f32 forward)
  4d text    DA-CLIP's text side at full width on the serve phase's bf16
             DaCLIP (text tower: width 512, 12 layers, 8 heads, context 77)
             with seeded level-predictor regressors: the tokenizer's host ms
             for the 10 class names and the 28 level prompts; text_features
             cold and cached; encode_text at B = 28, 256 and 1024 (median ms,
             prompts/s, peak memory beside what was resident);
             classify_degradation on four seeded 256² images (median ms,
             top-1); DaCLIP(use_predictor=True).forward on 16 images with
             both banks; the zero-shot classifier over the 10 classes × the
             80 templates; no hand kernel launched. Then an f32 copy on the
             card (TF32 off) against the same on the CPU, ≤ 1e-4: the 38
             prompts' unit-norm features, the four images' probabilities,
             the predictor's outputs (of their max); and each bf16 text
             feature's cosine to its f32 one ≥ 0.99
 4e gradio   serve/gradio_app.build_app on the serve phase's restorer (gradio,
             or a stand-in for the UI library alone where it does not
             import): one 256² uint8 request through the app's handler, the
             exact launches of #1 (600) and #2 (300), the degradation name
             equal to classify_degradation's, a uint8 RGB image of the
             input's shape
 4f shard_tiles  DACLIPRestorer.shard_tiles on the serve phase's restorer
             (tile_size 512, overlap 64, tile_batch 8): a seeded 1024² image is
             3 × 3 tiles of 384²; restored unsharded (batches of 8 + 1), then
             twice sharded over every card, or cuda:0 listed twice on one
             card (8 + 8, 7 of them padding; each UNet call split in equal
             chunks, one a listed card): the first tile batch's first UNet
             call split against whole within 3× the whole call's distance
             from an f32 UNet, its tiles after the T steps within that
             call's distance from f32 relative to their max (on seeded
             weights the samples grow to ~10³), the two sharded images
             equal bit for bit, the exact launches of
             #1 and #2 on each
             restore (unsharded 1200 / 600, over two 2400 / 1200), each
             restore's seconds and peak memory beside the card's name and
             power limit; cuDNN deterministic during the phase
  5 profile  one sampler step (a UNet forward at 256²): wall time, device
             kernel time by name, by the port's kernel namespaces and that of
             the 3×3 convs (torch.profiler)
  6 kernels_bwd  at every shape of the training step (B=16, 256²; the wrap
             also on balanced inputs), one f32 case each with TF32 off, the
             ragged wrap, the wrap's widths of phase 2 (untimed): the forward
             as training calls it (keeping the
             backward's statistics) against the plain forward, then each
             backward kernel against its plain backward, every gradient
             relative to its own max (dW_qkv per q/k/v block), flash also
             at N of 65 and 129; the wrap's forward and backward and flash's
             backward called twice (the bytes must repeat); event and device
             times, bounds, for flash the backward of
             scaled_dot_product_attention as the yardstick, and at each wrap
             site its weight-gradient launch (dW_qkv = xnᵀ·dqkv) against an
             f32 matmul and beside torch.matmul(xn.T, dqkv) (timed here only)
  7 train_check  a small UNet (a wrap and a SpatialTransformer) in f32: the
             loss and every parameter gradient through the kernels against
             the same through the plain versions, then 8 AdamW steps on one
             fixed batch and (t, noise) draw must lower the loss
  8 train    the production training step at full width (B=16, 256², nf 64,
             ch_mult 1,2,4,8, context 512, bf16, remat, AdamW + cosine + EMA)
             on seeded weights with the frozen DaCLIP's contexts: 2 warm-up
             and 5 timed steps, kernel calls per step; then a checkpoint
             whose EMA UNet restores a 256² image through DACLIPRestorer
  9 profile_train  torch.profiler over one full-width training step
 10 train_alt  the same step in the (v4, pointwise) wiring: 2 warm-up and 3
             timed steps, peak memory, kernel calls per step, a profile of
             one step
 11 train_cli  `cli.train_restoration -opt train.yml` in process: the
             production options (configs/daclip-sde/train.yml, distortion cut
             to the tree's two types) on seeded PNG folders (2 × 8 pairs at
             288 × 320, half with Up rows and half with Paeth; 2 val pairs at
             256 × 272) with a seeded ViT-B-32 DA-CLIP .pt: 1 step with
             validation (2 images, 10 sampler steps) and a checkpoint, a
             resume to 2, the exact launches of kernels #1-#4 (steps and
             validation), the images the native decoder read (at least
             one), the step function timed by a hook; then a fresh run of
             CLI_PACE_STEPS steps with no validation or checkpoint inside
             it, timed step start to step start; before them, PNG decode ms
             per row filter and the DataLoader's samples/s alone at 0 and 8
             workers; after them, `cli.test_restoration
             --lpips-weights` on the saved EMA UNet over 2 LQGT pairs (256²)
             in an LMDB packed by `tools.create_lmdb`, at T=100, with the
             lpips phase's weights: a finite LPIPS a pair, and the exact
             launches of #1 and #2 (its path: test_lpips)
11b wild_ir  the Wild-IR configuration (configs/wild-ir: a seeded ViT-L-14
             DaCLIP, 0.76 B parameters, image context only; the UNet nf 64,
             ch_mult 1,2,4,8, context 768, scale 0.5, bf16, v5): the shapes
             of #1 and #2 read off one forward at B = 1 and 16, #1 and #2 at
             each (balanced wrap inputs too), #3 and #4 at B = 16, each
             against its plain version and repeating bit for bit, with
             SDPA's forward and backward beside #2 and #4 (wild_ir_kernels);
             f32 on the card against the CPU (wild_ir_f32): encode_image(
             control=True) at B = 2, one UNet forward at 256², one training
             step at B = 2 (loss, parameters, the update at lr 1e-3, eps
             1e-3); train_wild: `cli.train_restoration -opt` on
             configs/wild-ir/train.yml (MDGT over 16 seeded GT PNGs at
             320 × 384 with Up rows, a 2-pair val set, a seeded .pt; B = 16,
             256², 3 steps with validation and a checkpoint at 2, a resume
             to 4), the exact launches of #1-#4, the frozen DaCLIP's
             contexts unchanged, the step by a hook, the loader alone at 0
             and 8 workers, random_degrade's and the CLIP view's host ms a
             256² patch; test_wild: `cli.test_restoration -opt` on
             configs/wild-ir/test.yml over a 256² and a 200 × 300 pair at
             T=100 with the saved EMA UNet, then `cli.predict --wild-ir` on
             one PNG, each with its exact launches of #1 and #2; wild_tools:
             tools.generate_lq for each type and tools.generate_masked, every
             output decoding
12 train_daclip  the fork's DA-CLIP training step at full width
             (daclip_ViT-B-32 with the level predictor, bf16, B = 512, AdamW
             lr 2e-5 wd 0.2 betas 0.9/0.98 eps 1e-6, cosine with warm-up) on
             seeded weights and a seeded batch (224² LQ and GT, caption‖
             degradation tokens, every degradation type present): 2 warm-up
             and 5 timed steps, peak memory, each loss term, a profile of one
             step; every term finite, FCRC > 0, the frozen CLIP unchanged bit
             for bit, logit_scale in [1, 100]; then one accum_freq 2 step at
             2 × 256 and one f32 step at B = 8 on the card against the same
             on the CPU (loss and parameters within 1e-4 of their max); no
             hand kernel launched
12b patch_dropout  train_daclip's step with --force-patch-dropout 0.5 (the
             same seeded model and batch): each tower's ln_pre sees 1 + 24
             tokens in training and 1 + 49 without; the step's ms, samples/s
             and peak memory beside train_daclip's; then the f32 step at B = 8
             on the card against the CPU with one patch noise (the same
             limits); no hand kernel launched
13 train_daclip_cli  `cli.train_daclip.main` in process on a seeded CSV of 16
             LQ/GT PNG pairs (224-288 px sides, half Up and half Paeth rows)
             and a val CSV of 8: --da, daclip_ViT-B-32, --precision amp,
             batch 8, 4 workers, 1 epoch, then --resume latest to 2; the
             loader's samples/s alone, the step by a hook on the trainer's
             `make_train_step`; the epochs' checkpoints, best/, finite val
             metrics, and the last checkpoint through DACLIPRestorer.load
             with a seeded production UNet, which classifies one image; no
             hand kernel launched. Cut: the batch (8, not 512) and the tree,
             for the host's PNG decode; inspect_checkpoint on its train dir;
             then fast_clip_view: the loader alone with `--fast-clip-view`'s
             cv2 decode and view beside the PIL path's, and one epoch of the
             CLI with it (no val set), no hand kernel launched
13b train_daclip_wds  `cli.train_daclip.main` on a plain ViT-B-32 (bf16) over
             4 seeded tar shards of Up-filtered PNG + txt (32 samples), B = 8,
             --force-patch-dropout 0.5, ImageNet zero-shot every epoch on a
             seeded 4-class tree, --remote-sync to a local path by fsspec, 2
             epochs; then the local checkpoints deleted and --resume latest
             to 3, which fetches them from the remote (the step counter and
             AdamW's moments go on); its weights a registry tag, a seeded .pt
             in a cache dir under a URL that names its sha256, loaded through
             download_pretrained_from_url and the factory while urlopen
             refuses any call; the loader's samples/s alone, the step by a
             hook, step to step; the zero-shot rows, the remote mirroring the
             log dir; no hand kernel launched
14 eval     the eval CLIs and tools at full width on a seeded daclip_ViT-B-32
             with the level predictor, saved as a port .pt and as a
             daclip_tpu .npz, over a seeded tree of 4 classes × 16 LQ PNGs
             (224-288 px sides, Up rows), bf16 on the card:
             eval.evaluate_daclip with both checkpoints (so
             compare_checkpoints runs; the two must give equal predictions),
             eval.evaluate_numclip at B = 32 (its image loop timed by hooks:
             host decode and transform, device encode), imagenet_zero_shot.
             evaluate on a 3-class tree with the 80 templates, tools.
             encode_folder on the class tree and on a flat folder, tools.
             inspect_checkpoint on the .pt and the .npz; the files each
             writes, accuracies in [0, 1], a finite regression MAE, unit-norm
             features (2e-2), the plots written where matplotlib imports
             (each returning False where it does not); then the f32 features
             of 4 images on the card against the CPU (1e-4 of their max); no
             hand kernel launched
15 lpips    LPIPS(alex) on seeded AlexNet-shaped weights in daclip_tpu's
             layout: the card against the CPU, f32, 4 pairs at 256² (1e-5
             relative), and its ms a pair (run before train_cli, whose
             test_restoration scores LPIPS with these weights)
16 stage_profile  utils.stage_profile at B = 4, 256², bf16 on the card: each
             row's ms, every row finite and positive, the exact launches of
             #1 (the three linear wraps, 31 calls each) and #2 (the level-3
             SpatialTransformer); then utils.profile for daclip_ViT-B-32 and
             the 256² UNet on the card, whose parameter counts and FLOPs must
             equal those on the CPU, and encode_image(control=True)'s ms at
             B = 1 beside its FLOPs
17 ddp_train  (after patch_dropout, in one NCCL group that torchrun's
             environment for one process forms in process, through
             daclip_torch.parallel) train's step at full width from its
             seeded UNet, 3 steps on one batch and draw sequence: in one
             process twice (the second a control), through DDP and through
             FSDP2 (fsdp_train), cuDNN deterministic; DDP's and FSDP's
             parameters equal the single process's bit for bit; step ms and
             peak memory of each beside train's; the exact
             launches of #1-#4 on each path
18 fsdp_train  (printed with ddp_train)
19 ddp_daclip  train_daclip's step (B = 512, bf16) through DDP and the
             gathered losses in that group: ms, samples/s, peak memory beside
             train_daclip's; an f32 step at B = 8 through DDP within 1e-6 of
             the largest |parameter| of the same step without it; no hand
             kernel launched
20 two_ranks_one_card  two processes on cuda:0 over gloo (NCCL refuses two
             ranks on one device), DDP and the gathered losses at world size
             2: an f32 DA-CLIP step on 32 rows each within 1e-6 of the largest
             |parameter| of one process's step on all 64; no hand kernel
21 torchrun_cli  `python -m torch.distributed.run --standalone
             --nproc_per_node 1 -m` each train CLI with `--mesh 1`:
             train_daclip one epoch over train_daclip_cli's seeded CSV tree,
             train_restoration 2 steps over train_cli's options and MD tree
             (both trees' PNGs with Up rows only: the Paeth decode is those
             phases' to time); exactly one checkpoint each, loaded into the
             single-card model
22 towers   (after stage_profile) RN50, convnext_base, EVA02-B-16,
             swin_base_patch4_window7_224, vit_medium_patch16_gap_256,
             vit_relpos_medium_patch16_cls_224, ViT-M-16-alt and coca_ViT-B-32
             through create_model_and_transforms at their published widths,
             seeded (BatchNorm variances positive, layer-scale gammas near
             0.5): f32 encode_image on the card against the CPU at B = 2
             (1e-4 of the output's max), the bf16 features' cosine to f32
             (>= 0.99), bf16 encode_image ms, images/s and peak memory at
             B = 64; no hand kernel launched
23 towers_train  an f32 plain-CLIP step under --lock-image on RN50 (B = 8)
             and convnext_base (B = 4), card against CPU: the update
             p_after - p_before within 1e-2 of its max, the locked parameters
             unchanged bit for bit; `cli.train_daclip.main --model
             convnext_base --lock-image` (amp, B = 8, 4 workers) one epoch
             over train_daclip_cli's seeded CSV tree (Up rows), step to step;
             imagenet_zero_shot.evaluate on a seeded convnext_base .pt over a
             3-class tree with the 80 templates; no hand kernel launched
24 coca     coca_ViT-B-32, seeded, f32 card against CPU: the latents and
             caption logits (1e-4 of their max), coca_loss (1e-4 relative),
             generate_beam (6 beams, 3 groups, B = 4, SOT + 30 tokens) and
             generate (top-k 5, the same Gumbel draws on both) with equal
             tokens; bf16 ms of a caption batch of each; no hand kernel
25 hf_text  a roberta-base-shaped HFTextTower (mean pooler, mlp projection
             to 512) from a config directory the phase writes, on
             transformers' PyTorch model: f32 card against CPU (1e-4 of the
             max), bf16 cosine (>= 0.99), bf16 ms at B = 256 × 77 tokens; no
             hand kernel launched
(train_check runs the default wiring, then (v4, pointwise) and (v3, pointwise).)
Then each kernel's device time over its library call's (kernels_vs_library),
the script's seconds (total), the per-kernel summary line, the nvidia-smi
line, and as the last line
{"ok": true, "device": {...}}. Any failed check raises and exits non-zero;
without a CUDA device it exits non-zero before printing any result.
"""
import concurrent.futures
import contextlib
import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time
from functools import partial

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent
FIXTURE = REPO / "tests" / "parity" / "fixtures" / "e2e"

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

WRAP_SHAPES = [  # (B, n, C, dtype): the six sites at 256² plus a ragged and f32 case
    (1, 65536, 64, torch.bfloat16), (1, 16384, 64, torch.bfloat16),
    (1, 16384, 128, torch.bfloat16), (1, 4096, 128, torch.bfloat16),
    (1, 4096, 256, torch.bfloat16), (2, 3001, 96, torch.bfloat16),
    (1, 1024, 32, torch.float32)]
FLASH_SHAPES = [  # (B, N, H, D, dtype): down3 and mid/up3 at 256², the fixture's mid
    (1, 1024, 8, 32, torch.bfloat16), (1, 1024, 16, 32, torch.bfloat16),
    (1, 256, 2, 32, torch.float32)]
# the training step's forward at down3 and mid/up3 (B=16), keeping the lse
FLASH_TRAIN_SHAPES = [(16, 1024, 8, 32, torch.bfloat16), (16, 1024, 16, 32, torch.bfloat16)]
# shard_tiles' 384² tiles: mid/up3 at the full tile batch (the unsharded
# restore) and down3 at a chunk of half of it (split over two); the wrap at
# level 0 (n = 384²) on such a chunk
SHARD_FLASH_SHAPES = [(8, 2304, 16, 32, torch.bfloat16), (4, 2304, 8, 32, torch.bfloat16)]
# the bf16 forward's tile edges, keeping the lse: N under one 64-row TMA box,
# one box, one query or key past a box, and odd B, H and N
FLASH_EDGE_SHAPES = [(1, 50, 2, 32, torch.bfloat16), (1, 64, 1, 32, torch.bfloat16),
                     (1, 130, 2, 32, torch.bfloat16), (3, 257, 3, 32, torch.bfloat16),
                     (2, 65, 4, 32, torch.bfloat16), (2, 65, 4, 64, torch.bfloat16),
                     (2, 1000, 4, 64, torch.bfloat16)]
SHARD_WRAP_SHAPES = [(4, 147456, 64, torch.bfloat16)]
# widths the wrap kernels take besides the production UNet's (every C from 1
# to 512): an nf 16 UNet's levels 0 and 1 (the orbax fixture's), nf 48's
# level 0, C = 80 (a whole 64-column box and one of 16) at a ragged n; nf 8,
# 12, 24 and 40 UNets' level 0 (C = 12 and the odd 9 not a multiple of 8:
# rows laid out at the next multiple of 8, the LayerNorms over the true
# width), ragged n among them; and f32 at C = 12, 16, 24 and 48 (where the
# f32 kernels' last stage of K and of columns is partial); checked forward,
# backward, #5 and #6, untimed
WRAP_WIDTH_SHAPES = [(2, 1024, 16, torch.bfloat16), (1, 4096, 32, torch.bfloat16),
                     (2, 1000, 48, torch.bfloat16), (2, 301, 80, torch.bfloat16),
                     (2, 1024, 8, torch.bfloat16), (2, 1000, 12, torch.bfloat16),
                     (1, 4096, 24, torch.bfloat16), (2, 301, 40, torch.bfloat16),
                     (1, 777, 9, torch.bfloat16),
                     (1, 1024, 16, torch.float32), (2, 301, 48, torch.float32),
                     (2, 1000, 12, torch.float32), (1, 301, 24, torch.float32)]
LIMITS = {("wrap", torch.bfloat16): 0.1, ("wrap", torch.float32): 1e-3,
          # relative to the output's max: the core's output is the attention
          # alone; the 1×1 rounds once to bf16 (half a step is 2^-8 of a value);
          # flash rounds its output once to bf16 as well (read: 2-3e-3 of max on
          # the H100 at every shape, N = 65 to 1024)
          ("flash", torch.bfloat16): 8e-3, ("flash", torch.float32): 1e-5,
          ("core", torch.bfloat16): 2e-2, ("core", torch.float32): 1e-4,
          ("dual", torch.bfloat16): 1e-2, ("dual", torch.float32): 1e-5,
          # the 3×3 conv rounds once to bf16 too; the sums run in another order
          ("conv", torch.bfloat16): 1e-2, ("conv", torch.float32): 1e-5}
# dual_conv1x1 at the res_conv sites of the UNet at 256² (rows = H·W at B=1;
# K = Cx + Cs: the up level's x and its skip, the final block's x and x_skip):
# (rows, Cx, Cs, O) — up3 ×2, up2 ×2, up1 ×2, up0 ×2 and final; a ragged and an
# f32 case; then the bf16 kernel's tile edges: Kx, Ks and O not multiples of 8
# (element copies), a row past 65 tiles with O = 200 (a ragged last panel) and
# a ragged last K slice, 16 K slices (four turns of the ring), one row past a
# tile with an odd O, and K past the 16 slices a CTA of its 64 × 64 tiles holds
# resident (split over a cluster of eight, a ragged last K slice); then the
# 256 × 128 tiles with streamed weights at their edges: rows past a multiple
# of 256, K slices of x and of skip ragged, O = 264 (a last column block of
# one 8-wide panel and one wholly past O), and K past 128 slices (more than
# eight splits hold resident) with Kx and Ks not multiples of 8 (the rows
# and weights element by element; the single form's K = 8200 by TMA)
DUAL_SHAPES = [(1024, 512, 256, 512, torch.bfloat16), (4096, 256, 128, 256, torch.bfloat16),
               (16384, 128, 64, 128, torch.bfloat16), (65536, 64, 64, 64, torch.bfloat16),
               (3001, 96, 40, 72, torch.bfloat16), (4096, 64, 64, 64, torch.float32),
               (1000, 36, 20, 50, torch.bfloat16), (4161, 64, 40, 200, torch.bfloat16),
               (2048, 512, 512, 96, torch.bfloat16), (65, 24, 16, 33, torch.bfloat16),
               (257, 640, 520, 40, torch.bfloat16), (16461, 200, 72, 264, torch.bfloat16),
               (300, 4100, 4100, 40, torch.bfloat16)]
# the (v4, pointwise) training step's shapes (B=16, 256²): linear_attention_fused
# at the five (B, n, C) of the six sites, dual_conv1x1's single form at 16× the
# rows of the four res_conv shapes
TRAIN_WRAP_SHAPES = [(16, n, C, dtype) for _, n, C, dtype in WRAP_SHAPES[:5]]
TRAIN_DUAL_SHAPES = [(16 * R, cx, cs, O, dtype) for R, cx, cs, O, dtype in DUAL_SHAPES[:4]]
# the 3×3 stride-1 convs of the production UNet (nf 64, ch_mult 1,2,4,8) at 256²:
# (H = W, C, O, sites), the 15 distinct shapes of its 44 sites (13 at 256², 9 at
# 128², 9 at 64², 13 at 32²)
CONV_SITES = [(256, 64, 64, 8), (256, 128, 64, 4), (256, 64, 3, 1),
              (128, 64, 64, 4), (128, 192, 128, 2), (128, 128, 128, 2), (128, 256, 128, 1),
              (64, 128, 128, 4), (64, 384, 256, 2), (64, 256, 256, 2), (64, 512, 256, 1),
              (32, 256, 256, 4), (32, 256, 512, 1), (32, 512, 512, 6), (32, 768, 512, 2)]
CONV_SITES_PER_FORWARD = 44
# (B, H, W, C, O, dtype): the sites at B=1; the three largest at the training
# batch (other grid sizes, up to 1,048,576 pixels); a ragged bf16 and an f32
# case; then the bf16 kernel's tile edges: W of 65 and 33 (a second, or a
# mostly empty, 64-pixel tile column), odd H, O = 200 (four 64-output tiles,
# the last ragged); C = 96 and 160 on its large tile, C = 520 (a ragged last
# 32-channel slice, K split over a cluster) and 40 on its small one
CONV_SHAPES = ([(1, s, s, C, O, torch.bfloat16) for s, C, O, _ in CONV_SITES]
               + [(16, 256, 256, 64, 64, torch.bfloat16), (16, 256, 256, 128, 64, torch.bfloat16),
                  (16, 32, 32, 768, 512, torch.bfloat16), (2, 37, 45, 6, 72, torch.bfloat16),
                  (2, 33, 40, 64, 48, torch.float32),
                  (4, 67, 65, 96, 200, torch.bfloat16), (2, 37, 33, 160, 200, torch.bfloat16),
                  (1, 31, 33, 520, 200, torch.bfloat16), (2, 9, 65, 40, 72, torch.bfloat16)])
ALT_CONFIGS = {"v4_pointwise": dict(linear_attention="v4", pointwise=True),
               "v3_pointwise": dict(linear_attention="v3", pointwise=True),
               "v5_pointwise": dict(linear_attention="v5", pointwise=True)}
# an alt wiring's bf16 forward may differ from the v5 wiring's by at most this
# many times the v5 bf16 forward's own max distance from its f32 forward
ALT_FORWARD_FACTOR = 3.0
# the backward kernels at the training step's shapes: (B, n, C) of the six
# wrap sites at 256² and B=16 (down0/up0 share a shape), the ragged case, an
# f32 case, and C=512 (the context-free UNet's level 3, the kernel's 32-row
# tiles); flash at down3 and mid/up3, an f32 case, dim_head 64 with a
# ragged N, N of 65 and 129 at both dim_heads, and the forward's edges
WRAP_BWD_SHAPES = [
    (16, 65536, 64, torch.bfloat16), (16, 16384, 64, torch.bfloat16),
    (16, 16384, 128, torch.bfloat16), (16, 4096, 128, torch.bfloat16),
    (16, 4096, 256, torch.bfloat16), (2, 3001, 96, torch.bfloat16),
    (2, 4096, 64, torch.float32), (2, 1024, 512, torch.bfloat16)]
FLASH_BWD_SHAPES = [(16, 1024, 8, 32, torch.bfloat16), (16, 1024, 16, 32, torch.bfloat16),
                    (2, 1024, 4, 32, torch.float32), (2, 1000, 4, 64, torch.bfloat16),
                    # the bf16 kernels' tile edges: one key/query past a 64-row tile
                    (2, 65, 4, 32, torch.bfloat16), (2, 129, 4, 32, torch.bfloat16),
                    (2, 65, 4, 64, torch.bfloat16), (2, 129, 4, 64, torch.bfloat16),
                    # N under one box, one box, odd B, H and N
                    (1, 50, 2, 32, torch.bfloat16), (1, 64, 1, 32, torch.bfloat16),
                    (3, 257, 3, 32, torch.bfloat16)]
# each gradient's max |kernel − plain| over its own max |plain|, the plain
# backward in f32 on the same inputs; set at about 3× (bf16) and 5× (f32) the
# worst reading of the first H100 runs (0.0063 wrap, 0.0044 flash in bf16,
# balanced inputs included; 1.8e-6 and 9e-7 in f32 with TF32 off)
BWD_LIMITS = {("wrap", torch.bfloat16): 2e-2, ("wrap", torch.float32): 1e-5,
              ("flash", torch.bfloat16): 2e-2, ("flash", torch.float32): 1e-5}
# the weight-gradient launch (f32 sums of bf16 products over up to 1,048,576
# rows, in another order) against an f32 matmul, relative to its max
WGRAD_LIMIT = 1e-4
TRAIN_CHECK_LIMIT = 1e-4  # worst per-tensor relative gradient error, f32 (read: 2e-6)
# the H100 SXM's exponentials a second on its special-function units
# (FlashAttention-3, Shah et al. 2024, §3): a flash row's `exp_floor_ms` is
# its exponentials at that rate (B·H·N² a pass; the backward takes two)
EXP_PER_S = 3.9e12
# the bf16 flash kernels by their ptxas_summary names
FLASH_KERNELS = tuple(f"{ns}::tc::{k}_wgmma_kernel<{d}>" for d in (32, 64)
                      for ns, k in (("flash", "fwd"), ("flash_bwd", "dq"), ("flash_bwd", "dkv")))
_FLASH_PTXAS = {}  # the build's ptxas lines of those kernels, for the flash rows
# the bf16 dual 1×1 and 3×3 conv kernels by their ptxas_summary names, by
# (tile shape index of the plan, element path: four producer warps)
DUAL_KERNELS = {(0, False): "pointwise::tc::dual_tma_kernel<1,1,true,1>",
                (0, True): "pointwise::tc::dual_tma_kernel<1,1,true,4>",
                (1, False): "pointwise::tc::dual_tma_kernel<4,2,false,1>"}
CONV_KERNELS = {(0, False): "conv3x3::tc::conv_tma_kernel<4,1,3>",
                (0, True): "conv3x3::tc::conv_tma_kernel<4,4,3>",
                (1, False): "conv3x3::tc::conv_tma_kernel<2,1,9>",
                (1, True): "conv3x3::tc::conv_tma_kernel<2,4,9>"}
_PW_CONV_PTXAS = {}  # the build's ptxas lines of those kernels, for their rows
# the forward's log-sum-exp against torch.logsumexp of the f32 logits (read:
# 1.4e-6 in bf16, from f32 sums of exponentials on the SFU)
LSE_LIMIT = 1e-4
WRAP_MEAN_LIMIT_BF16 = 1e-2
# on balanced wrap inputs the attention's share of the output (the plain
# output minus the plain output with no attention) must be of order 1
SIGNAL_MIN = 0.3


def emit(**kw):
    print(json.dumps(kw), flush=True)


def kernel_counters():
    """Every kernel wrapper, whose `launches` counts its kernel's launches, by
    the key the summary line uses."""
    from daclip_torch.ops import flash_attention as fa
    from daclip_torch.ops import linear_attention as la
    from daclip_torch.ops import pointwise as pw
    from daclip_torch.ops.conv3x3 import conv3x3

    return {"wrap": la.attn_wrap, "flash": fa.flash_self_attention,
            "wrap_bwd": la.attn_wrap_bwd, "flash_bwd": fa.flash_self_attention_bwd,
            "fused_v4": la.linear_attention_fused, "wrap_fused": la.attn_wrap_fused,
            "core": la.linear_attention, "dual": pw.dual_conv1x1, "conv3x3": conv3x3}


def reset_counts():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts():
    return {key: fn.launches for key, fn in kernel_counters().items()}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, iters=20, warmup=3):
    """Median of `iters` CUDA-event timed calls after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


_SLEEP_CYCLES_PER_MS = []


def sleep_cycles_per_ms():
    """The device clock cycles `torch.cuda._sleep` spins a millisecond,
    timed once by CUDA events."""
    if not _SLEEP_CYCLES_PER_MS:
        torch.cuda._sleep(1000)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        end.synchronize()
        _SLEEP_CYCLES_PER_MS.append(20_000_000 / start.elapsed_time(end))
    return _SLEEP_CYCLES_PER_MS[0]


PROFILE_PAD_S = 0.005  # host time inside a profiler window, before and after its calls


@contextlib.contextmanager
def profiled(activities, pad_s=PROFILE_PAD_S, **kwargs):
    """A torch.profiler window that holds `pad_s` of host time before the
    calls made in it and after them. Unpadded, about one window in a hundred
    of ten small calls records no kernel at all, on an H100 with torch 2.11
    (scripts/torch_profiler_window_probe.py); with the pad, none of 800 did."""
    from torch.profiler import profile

    with profile(activities=activities, **kwargs) as prof:
        time.sleep(pad_s)
        yield prof
        time.sleep(pad_s)


def kernel_names(fn, iters=10, split=None):
    """The names of the device kernels that `iters` calls of `fn` launch
    (torch.profiler, in a padded window); a window that records none is
    taken again with a pad 4× as long, three times at most. With `split` (a
    dict), also each kernel's device ms a call in that window, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    for attempt in range(4):
        with profiled([ProfilerActivity.CUDA], PROFILE_PAD_S * 4 ** attempt) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        names = sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA})
        if names and attempt:  # say so beside the row that follows
            emit(phase="kernel_names_retaken", kernels=names[:3], attempts=attempt + 1)
        if names:
            if split is not None:
                split.update({e.key.split("(")[0][-70:]: e.device_time_total / iters / 1e3
                              for e in prof.key_averages() if e.device_time_total > 0})
            return names
    return []


def device_ms(fn, match, iters=10, split=None):
    """Device time per call of `fn`: CUDA events around `iters` calls queued
    behind a `torch.cuda._sleep` that outlasts the host's enqueue of them
    all, so that the span holds the calls' device work back to back and no
    host gap. Unlike `time_ms`, which times each call between two events,
    it leaves out the wrapper's host time, which a small kernel can take
    less than. torch.profiler only names the kernels: the calls must launch
    one whose name holds `match`. A window whose calls the device reached
    before the host had queued them all is not kept: it is taken again
    behind a sleep 4× as long (the sleep stays outside the span), twice at
    most (the host, sharing its cores, can stall past one estimate), and a
    `device_ms_retaken` line names the kernels, the tries and the last
    sleep; after three tries the run fails. With `split` (a dict), the
    profiler's window also fills it with each kernel's device ms a call."""
    fn()
    torch.cuda.synchronize()
    names = kernel_names(fn, iters, split)
    check(any(match in n for n in names), f"no kernel named {match!r} among {names}")
    t0 = time.perf_counter()
    fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 * iters
    for attempt in range(3):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        sleep_ms = (2.0 + 4.0 * enqueue_ms) * 4 ** attempt
        torch.cuda._sleep(int(sleep_ms * sleep_cycles_per_ms()))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_first = not start.query()
        end.synchronize()
        if queued_first:
            if attempt:  # the host stalled: say so beside the row that follows
                emit(phase="device_ms_retaken", kernels=names[:3], attempts=attempt + 1,
                     sleep_ms=sleep_ms, enqueue_ms=enqueue_ms)
            return start.elapsed_time(end) / iters
    check(False, f"device_ms: the device reached the calls before the host had queued "
          f"them, three times ({names[:3]}, enqueue {enqueue_ms:.3f} ms, last sleep "
          f"{sleep_ms:.1f} ms)")


def check_flash_build(ptxas):
    """Keep the build's lines of the bf16 flash kernels for their rows; fail
    if one is missing or one at dim_head 32 (the UNet's) spills."""
    _FLASH_PTXAS.update({ln.split(": ")[0]: ln for ln in ptxas
                         if ln.split(": ")[0] in FLASH_KERNELS})
    check(set(_FLASH_PTXAS) == set(FLASH_KERNELS),
          f"the build log names {sorted(_FLASH_PTXAS)} of the flash kernels {FLASH_KERNELS}")
    spills = [ln for k, ln in _FLASH_PTXAS.items()
              if k.endswith("<32>") and not (re.search(r"(?<!\d)0 bytes spill stores", ln)
                                      and re.search(r"(?<!\d)0 bytes spill loads", ln))]
    check(not spills, f"bf16 flash kernels at dim_head 32 spill: {spills}")


def check_pointwise_conv_build(ptxas):
    """Keep the build's lines of the bf16 dual 1×1 and 3×3 conv kernels for
    their rows; fail if one is missing or spills."""
    names = set(DUAL_KERNELS.values()) | set(CONV_KERNELS.values())
    _PW_CONV_PTXAS.update({ln.split(": ")[0]: ln for ln in ptxas if ln.split(": ")[0] in names})
    check(set(_PW_CONV_PTXAS) == names,
          f"the build log names {sorted(_PW_CONV_PTXAS)} of the kernels {sorted(names)}")
    spills = [ln for ln in _PW_CONV_PTXAS.values()
              if not (re.search(r"(?<!\d)0 bytes spill stores", ln)
                      and re.search(r"(?<!\d)0 bytes spill loads", ln))]
    check(not spills, f"bf16 dual 1×1 or 3×3 conv kernels spill: {spills}")


def dual_resources(R, Kx, Ks, O):
    """The bf16 dual 1×1's schedule at (R, Kx, Ks, O) (ops/pointwise.py
    `_dual_plan`), the ptxas line of the kernel it launches and its dynamic
    shared memory bytes (the launcher's own count, held to the plan's)."""
    from daclip_torch.ops import _build
    from daclip_torch.ops import pointwise as pw

    plan = pw._dual_plan(R, Kx, Ks, O, _build.sms("cuda"))
    elem = plan.cfg == 0 and (Kx % 8 != 0 or Ks % 8 != 0 or O % 8 != 0)
    slices = -(-Kx // 64) + -(-Ks // 64)
    res = -(-slices // plan.splits) if plan.cfg == 0 else 0  # the largest split's, resident
    smem = _build.library().daclip_dual_smem(plan.cfg, plan.stages, res)
    check(smem == plan.smem, f"dual_conv1x1 {R, Kx, Ks, O}: the launcher's {smem} bytes of "
          f"shared memory against the plan's {plan.smem}")
    name = DUAL_KERNELS[(plan.cfg, elem)]
    return {"plan": plan._asdict(), "ptxas": [_PW_CONV_PTXAS.get(name, f"{name}: not in the "
                                                                 "build log")],
            "smem_bytes": [smem]}


def conv_resources(B, H, W, C, O):
    """The bf16 3×3 conv's schedule at (B, H, W, C, O) (ops/conv3x3.py
    `_conv_plan`), the ptxas line of the kernel it launches and its dynamic
    shared memory bytes (the launcher's own count, held to the plan's)."""
    import importlib

    from daclip_torch.ops import _build

    cv = importlib.import_module("daclip_torch.ops.conv3x3")
    plan = cv._conv_plan(B, H, W, C, O, _build.sms("cuda"))
    smem = _build.library().daclip_conv_smem(plan.cfg, plan.stages)
    check(smem == plan.smem, f"conv3x3 {B, H, W, C, O}: the launcher's {smem} bytes of shared "
          f"memory against the plan's {plan.smem}")
    name = CONV_KERNELS[(plan.cfg, C % 8 != 0 or O % 8 != 0)]
    return {"plan": plan._asdict(), "ptxas": [_PW_CONV_PTXAS.get(name, f"{name}: not in the "
                                                                 "build log")],
            "smem_bytes": [smem]}


def flash_resources(kind, D):
    """ptxas's lines (registers, spills) of the bf16 flash kernels of `kind`
    ("fwd" or "bwd") at dim_head D and their dynamic shared memory bytes."""
    from daclip_torch.ops import _build

    lib = _build.library()
    if kind == "fwd":
        return {"ptxas": [_FLASH_PTXAS.get(f"flash::tc::fwd_wgmma_kernel<{D}>")],
                "smem_bytes": [lib.daclip_flash_fwd_smem(D)]}
    return {"ptxas": [_FLASH_PTXAS.get(f"flash_bwd::tc::{k}_wgmma_kernel<{D}>")
                      for k in ("dq", "dkv")],
            "smem_bytes": [lib.daclip_flash_bwd_smem(0, D), lib.daclip_flash_bwd_smem(1, D)]}


_LINATTN_PTXAS = {}  # the build's ptxas lines of the linear-attention kernels, for their rows


def linattn_resources(kind, C, form=0):
    """ptxas's lines (registers, spills) of the bf16 linear-attention kernels
    that one call launches at C ("fwd": stats, combine, apply in input form
    `form`, 0 raw x, 1 xn, 2 qkv with C = 384; "bwd": pass 1, mid, pass 2,
    the weight gradients dW_qkv and dW_out) and their dynamic shared memory
    bytes."""
    from daclip_torch.ops import _build

    lib = _build.library()
    keep = "true" if C <= 64 else "false"
    if kind == "fwd":
        apply_ = f"wrap::tc::apply_tma_kernel<{form},{'true' if form == 0 else 'false'},{keep}>"
        names = [f"wrap::tc::stats_tma_kernel<{form}>", "wrap::combine_kernel<bf16>", apply_]
        smem = [lib.daclip_wrap_smem(0, C, form), 0, lib.daclip_wrap_smem(1, C, form)]
    else:
        names = [f"wrap_bwd::tc::pass1_tma_kernel<{keep}>", "wrap_bwd::mid_kernel<bf16>",
                 f"wrap_bwd::tc::pass2_tma_kernel<{keep}>",
                 f"wrap_bwd::tc::wgrad_tma_kernel<{6 if C <= 64 else 2}>",
                 "wrap_bwd::tc::wgrad_tma_kernel<2>"]
        smem = [lib.daclip_wrap_bwd_smem(0, C), 0, lib.daclip_wrap_bwd_smem(1, C),
                lib.daclip_wrap_bwd_smem(2, C), lib.daclip_wrap_bwd_smem(3, C)]
    return {"ptxas": [_LINATTN_PTXAS.get(n, f"{n}: not in the build log") for n in names],
            "smem_bytes": smem}


def check_above_bounds(rows):
    """A kernel's or its library call's device time at or under the row's
    bound is a fault of the measurement: fail there."""
    for r in rows:
        for key in ("device_ms", "library_device_ms"):
            if r.get(key) is not None and r.get("bound_ms") is not None:
                check(r[key] > r["bound_ms"], f"{r['kernel']} {r['shape']} {r['dtype']}: "
                      f"{key} {r[key]} at or under its bound {r['bound_ms']} ms")
        fwd = r.get("forward") or {}
        if fwd.get("device_ms") is not None:  # a backward row's timed forward
            check(fwd["device_ms"] > fwd["bound_ms"], f"{r['kernel']} {r['shape']}: forward "
                  f"device_ms {fwd['device_ms']} at or under its bound {fwd['bound_ms']} ms")


def bound_ms(nbytes, flops, dtype):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ptxas_summary(log):
    """One line per compiled kernel of an `nvcc -Xptxas -v` log: its name
    (namespace::function<template arguments>, read off the mangled symbol;
    a configuration struct's arguments stand for the struct), registers,
    stack, spills and shared memory."""
    out, name, props = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Function properties for (_ZN\w+)", ln)
        if m:
            sym = m.group(1)
            parts, i = [], 3
            while i < len(sym) and sym[i].isdigit():
                j = i
                while sym[j].isdigit():
                    j += 1
                n = int(sym[i:j])
                parts.append(sym[j:j + n])
                i = j + n
            targs = re.match(r"I(.*?)EE", sym[i:])
            args = [{"13__nv_bfloat16": "bf16", "f": "f32", "Lb0E": "false",
                     "Lb1E": "true"}.get(a, a.strip("LiE"))
                    for a in re.findall(r"13__nv_bfloat16|Li-?\d+E|Lb[01]E|f(?=L|E|f|1)",
                                        targs.group(1) + "E" if targs else "")]
            name = "::".join(parts[1:]) + (f"<{','.join(args)}>" if args else "")
        elif name and "stack frame" in ln:
            props = ln.strip()
        elif name and "Used" in ln and "registers" in ln:
            out.append(f"{name}: {ln.split('Used', 1)[1].strip()}; {props}")
            name, props = None, ""
    return out


def psnr(a, b):
    mse = float(np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


# -- phase 1b ------------------------------------------------------------------
# the native decoder's files: each size at each quality (JPEG) or layout (PNG)
NATIVE_SIZES = [(1, 1), (7, 9), (67, 45), (250, 17), (512, 512)]
NATIVE_QUALITIES = (30, 75, 95, 100)
NATIVE_PACE_SHAPE = (288, 320)   # train_cli's MD images
NATIVE_JPEG_SIDE, NATIVE_CROP = 512, 256
NATIVE_BATCH = 64


def native_picture(rng, h, w, c=3):
    """uint8 smooth waves under noise, as a photograph gives an encoder."""
    yy, xx = np.mgrid[:h, :w]
    waves = (np.sin(xx[..., None] / 7.0 + np.arange(c)) * np.cos(yy[..., None] / 5.0) + 1) / 2
    return ((0.6 * waves + 0.4 * rng.rand(h, w, c)) * 255).astype(np.uint8)


def native_windows(W, H):
    """Whole, interior, lower-right quarter, 1 × 1, last column, last row."""
    return [(0, 0, W, H), (W // 3, H // 4, max(1, W // 2), max(1, H // 2)),
            (W // 2, H // 2, W - W // 2, H - H // 2), (W - 1, H - 1, 1, 1),
            (W - 1, 0, 1, H), (0, H - 1, W, 1)]


def png_bytes(samples, depth, ctype, plte=None, interlace=0, trns=None):
    """A PNG of (H, W, C) samples at any gray or palette depth or 8-bit RGB,
    Adam7 or not, its rows filtered with the types 0-4 in turn, with the
    PLTE and tRNS chunks given."""
    import struct
    import zlib

    from daclip_torch.data import png

    samples = samples.reshape(samples.shape[:2] + (-1,))
    H, W, C = samples.shape
    bpp = max(1, C * depth // 8)
    passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
              (1, 0, 2, 2), (0, 1, 1, 2)) if interlace else ((0, 0, 1, 1),)
    raw = []
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        h = sub.shape[0]
        bits = (sub[..., None] >> np.arange(depth - 1, -1, -1)) & 1
        rows = (sub.astype(np.uint8).reshape(h, -1) if depth == 8
                else np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1))
        x = rows.astype(np.int16)
        left, up, upleft = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
        left[:, bpp:] = x[:, :-bpp]
        up[1:] = x[:-1]
        upleft[1:, bpp:] = x[:-1, :-bpp]
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        preds = [np.zeros_like(x), left, up, (left + up) >> 1,
                 np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))]
        kinds = np.arange(h) % 5
        out = np.empty((h, x.shape[1] + 1), np.uint8)
        out[:, 0] = kinds
        for k, pred in enumerate(preds):
            out[kinds == k, 1:] = ((x - pred) & 0xFF)[kinds == k]
        raw.append(out.tobytes())
    data = png.SIGNATURE + png._chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0,
                                                           0, interlace))
    if plte is not None:
        data += png._chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        data += png._chunk(b"tRNS", trns)
    return (data + png._chunk(b"IDAT", zlib.compress(b"".join(raw)))
            + png._chunk(b"IEND", b""))


def native_cases(cv2, Image, rng):
    """{name: bytes}: the PNG and baseline-JPEG files the decoder takes."""
    import io

    from daclip_torch.data import png

    out = {}
    samplings = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                 "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                 "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                 "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
    for h, w in NATIVE_SIZES:
        tag = f"{h}x{w}"
        for c in (1, 3):
            img = native_picture(rng, h, w, c)
            for filt in png.FILTERS:
                out[f"png_{filt}_{c}_{tag}"] = png.encode(img, filt)
        for interlace in (0, 1):
            for depth in (1, 2, 4, 8):
                s = rng.randint(0, 2 ** depth, (h, w, 1))
                out[f"png_gray{depth}_i{interlace}_{tag}"] = png_bytes(s, depth, 0,
                                                                       interlace=interlace)
                out[f"png_palette{depth}_i{interlace}_{tag}"] = png_bytes(
                    s, depth, 3, rng.randint(0, 256, (2 ** depth, 3)), interlace)
            out[f"png_rgb_i{interlace}_{tag}"] = png_bytes(rng.randint(0, 256, (h, w, 3)), 8, 2,
                                                           interlace=interlace)
        for q in NATIVE_QUALITIES:
            img = native_picture(rng, h, w)
            enc = lambda a, *flags: cv2.imencode(".jpg", a, [cv2.IMWRITE_JPEG_QUALITY, q,
                                                             *flags])[1].tobytes()
            for name, sf in samplings.items():
                out[f"jpeg_cv2_{name}_q{q}_{tag}"] = enc(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sf)
            for sub in (0, 1, 2):
                buf = io.BytesIO()
                Image.fromarray(img[:, :, ::-1]).save(buf, "JPEG", quality=q, subsampling=sub)
                out[f"jpeg_pil_sub{sub}_q{q}_{tag}"] = buf.getvalue()
            out[f"jpeg_gray_q{q}_{tag}"] = enc(img[:, :, 0])
            out[f"jpeg_rst_q{q}_{tag}"] = enc(img, cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
            out[f"jpeg_gray_rst_q{q}_{tag}"] = enc(img[:, :, 1], cv2.IMWRITE_JPEG_RST_INTERVAL, 3)
            out[f"jpeg_optimize_q{q}_{tag}"] = enc(img, cv2.IMWRITE_JPEG_OPTIMIZE, 1,
                                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                   samplings["420"])
    return out


def native_outside(cv2, Image, rng):
    """{name: bytes}: files outside the decoder's set."""
    import io

    img = native_picture(rng, 24, 20)
    enc = lambda ext, a, *flags: cv2.imencode(ext, a, list(flags))[1].tobytes()
    base = enc(".jpg", img)
    sof = base.index(b"\xff\xc0")
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, "JPEG")
    return {"progressive.jpg": enc(".jpg", img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
            "411.jpg": enc(".jpg", img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                           cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411),
            "arithmetic.jpg": base[:sof + 1] + b"\xc9" + base[sof + 2:],   # SOF9
            "cmyk.jpg": buf.getvalue(),
            "16_bit.png": enc(".png", img.astype(np.uint16) * 257),
            "rgba.png": enc(".png", np.dstack([img, img[:, :, :1]])),
            "palette_trns.png": png_bytes(rng.randint(0, 4, (24, 20, 1)), 2, 3,
                                          rng.randint(0, 256, (4, 3)), trns=b"\x00\x80")}


def host_ms(fn, iters=20):
    """Median host ms of `iters` calls after one."""
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def run_native_io():
    """Phase 1b: the native decoder built, held against cv2 and timed."""
    import cv2
    from PIL import Image

    from daclip_torch.data import native_io, png
    from daclip_torch.data import util as dutil

    t0 = time.perf_counter()
    native_io.load()
    build_s = time.perf_counter() - t0
    gxx = subprocess.run([native_io._CXX, "--version"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    t0 = time.perf_counter()
    rng = np.random.RandomState(90)
    cases = native_cases(cv2, Image, rng)
    checked, windows = 0, []
    for name, data in cases.items():
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
        check(want is not None, f"native_io: cv2 cannot decode {name}")
        want = want[:, :, None] if want.ndim == 2 else want
        H, W = want.shape[:2]
        check(native_io.probe(data) == (W, H, want.shape[2]), f"native_io: probe of {name}")
        for x0, y0, cw, ch in native_windows(W, H):
            got = native_io.decode(data, crop=(x0, y0, cw, ch))
            check(np.array_equal(got, want[y0:y0 + ch, x0:x0 + cw]),
                  f"native_io: {name} window {(x0, y0, cw, ch)} differs from cv2")
            checked += 1
        windows.append((data, native_windows(W, H)[1], want))
    for threads in (1, 8):
        outs = native_io.decode_batch([d for d, _, _ in windows], [c for _, c, _ in windows],
                                      threads=threads)
        for (data, (x0, y0, cw, ch), want), got in zip(windows, outs):
            check(np.array_equal(got, want[y0:y0 + ch, x0:x0 + cw]),
                  f"native_io: decode_batch at {threads} threads differs from cv2")
    outside = native_outside(cv2, Image, rng)
    with tempfile.TemporaryDirectory() as d:
        for name, data in outside.items():
            try:
                native_io.decode(data)
                check(False, f"native_io: {name} decoded; it is outside the set")
            except ValueError:
                pass
            path = os.path.join(d, name)
            with open(path, "wb") as f:
                f.write(data)
            want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            want = (want[:, :, None] if want.ndim == 2 else want[:, :, :3]).astype(np.float32)
            check(np.array_equal(dutil.read_img(None, path), want / 255.0),
                  f"native_io: read_img of {name} differs from cv2")
    check_s = time.perf_counter() - t0

    img = native_picture(np.random.RandomState(91), *NATIVE_PACE_SHAPE)
    real_unfilter = png._unfilter
    pngs = {}
    for filt in ("paeth", "average"):
        data = png.encode(img, filt)
        row = dict(native_ms=host_ms(lambda: native_io.decode(data)),
                   png_decode_ms=host_ms(lambda: png.decode(data)),
                   cv2_ms=host_ms(lambda: cv2.imdecode(np.frombuffer(data, np.uint8),
                                                       cv2.IMREAD_UNCHANGED)))
        png._unfilter = png._unfilter_rows   # png.py's plain rows, one call
        try:
            t1 = time.perf_counter()
            plain = png.decode(data)
            row["plain_rows_ms"] = (time.perf_counter() - t1) * 1e3
        finally:
            png._unfilter = real_unfilter
        check(np.array_equal(plain, img) and np.array_equal(native_io.decode(data), img),
              f"native_io: the {filt} PNG does not decode to its image")
        pngs[filt] = row
    side, crop = NATIVE_JPEG_SIDE, NATIVE_CROP
    jimg = native_picture(np.random.RandomState(92), side, side)
    jpeg = cv2.imencode(".jpg", jimg, [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes()
    x0 = (side - crop) // 2
    window = (x0, x0, crop, crop)
    buf = np.frombuffer(jpeg, np.uint8)
    jpeg_row = dict(bytes=len(jpeg), sampling="4:2:0", quality=90,
                    native_ms=host_ms(lambda: native_io.decode(jpeg)),
                    native_crop_ms=host_ms(lambda: native_io.decode(jpeg, crop=window)),
                    cv2_ms=host_ms(lambda: cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)))
    check(np.array_equal(native_io.decode(jpeg, crop=window),
                         cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)[x0:x0 + crop, x0:x0 + crop]),
          "native_io: the 512² JPEG's window differs from cv2")
    batch = {}
    for threads in (1, 8):
        for key, crops in (("whole", None), ("crop", [window] * NATIVE_BATCH)):
            ms = host_ms(lambda: native_io.decode_batch([jpeg] * NATIVE_BATCH, crops,
                                                        threads=threads), iters=5)
            batch[f"{key}_threads_{threads}"] = NATIVE_BATCH * 1e3 / ms
    # train_cli's read of a Paeth PNG's 256² window on 8 threads: the C PNG
    # decoder in decode_batch's pool against png.py (zlib and the C unfilter,
    # the rest numpy) on a Python thread pool, the crop taken after
    paeth = png.encode(img, "paeth")
    pw = (0, NATIVE_PACE_SHAPE[0] - crop, crop, crop)
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        png_ms = host_ms(lambda: list(pool.map(
            lambda d: png.decode(d)[pw[1]:pw[1] + crop, pw[0]:pw[0] + crop],
            [paeth] * NATIVE_BATCH)), iters=5)
    native_png_ms = host_ms(lambda: native_io.decode_batch([paeth] * NATIVE_BATCH,
                                                           [pw] * NATIVE_BATCH, threads=8),
                            iters=5)
    png_batch = dict(native_decode_batch=NATIVE_BATCH * 1e3 / native_png_ms,
                     png_py_thread_pool=NATIVE_BATCH * 1e3 / png_ms)
    emit(phase="native_io", library=native_io._library_path(), compiler=gxx,
         build_s=build_s, files=len(cases), windows_checked=checked,
         outside_the_set=sorted(outside), check_s=check_s, host_cpus=os.cpu_count(),
         png_288x320=pngs, jpeg_512=jpeg_row, jpeg_crop=list(window),
         decode_batch_images_per_s=batch, batch=NATIVE_BATCH,
         paeth_window_images_per_s_8_threads=png_batch,
         seconds=time.perf_counter() - t0 + build_s)
    return dict(pngs=pngs, jpeg=jpeg_row, batch=batch, png_batch=png_batch)


# -- phase 2 -------------------------------------------------------------------
def wrap_case(B, n, C, dtype, gen, balanced):
    """Inputs for one wrap site.

    Production-like: the reference divides the attention by s·n, so here
    attn·W_out is ~1e-7 of the out-projection bias and the out-LN sees
    little else. These inputs check the kernel as the UNet calls it, but a
    wrong attention would hide under any limit. Balanced: a bias of unit
    std, and v scaled so that attn·W_out has the same std (plain version,
    f32). A wrong softmax, mask or scale, or a skipped attention, then moves
    the output by ~0.3-0.8 on average."""
    from daclip_torch.ops import linear_attention as la

    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x, g_pre, g_out = rnd(B, n, C), 1 + 0.1 * rnd(C), 1 + 0.1 * rnd(C)
    w_qkv, w_out, b_out = rnd(C, 384) * C ** -0.5, rnd(128, C) * 128 ** -0.5, rnd(C)
    if balanced:
        qkv = la._channel_ln(x, g_pre) @ w_qkv
        w_qkv[:, 2 * la.HID:] /= float((la.linear_attention_reference(qkv) @ w_out).std())
    else:
        b_out *= 0.1
    return [a.to(dtype).contiguous() for a in (x, g_pre, w_qkv, w_out, b_out, g_out)]


def attention_share(want, x, b_out, g_out):
    """Mean |plain output − the plain output with the attention left out|."""
    from daclip_torch.ops.linear_attention import _channel_ln

    return float((want - x - _channel_ln(b_out.expand_as(x), g_out)).abs().mean())


def wrap_check(B, n, C, dtype, gen, balanced, phase="kernels", path=None, timed=True):
    """The wrap forward at one site against its plain version (twice, the
    bytes must repeat), timed once a shape (unbalanced inputs) when `timed`;
    its row."""
    from daclip_torch.ops import linear_attention as la

    args = wrap_case(B, n, C, dtype, gen, balanced)
    got = la.attn_wrap(*args)
    torch.cuda.synchronize()
    repeats = torch.equal(la.attn_wrap(*args), got)
    fargs = [a.float() for a in args]
    want = la.attn_wrap_reference(*fargs)
    err = (got.float() - want).abs()
    limit = LIMITS[("wrap", dtype)]
    row = dict(phase=phase, kernel="attn_wrap", shape=[B, n, C],
               dtype=str(dtype).split(".")[-1], balanced=balanced,
               max_abs_err=float(err.max()), mean_abs_err=float(err.mean()), limit=limit,
               repeats_bitwise=repeats,
               attention_share=attention_share(want, fargs[0], fargs[4], fargs[5]))
    if path:
        row["path"] = path
    if timed and not balanced:  # time each shape once
        esize = args[0].element_size()
        nbytes = (2 * B * n * C + C * 384 + 128 * C + 3 * C) * esize
        bms, by = bound_ms(nbytes, 2 * B * n * (512 * C + 8192), dtype)
        split = {}  # each launch's device ms, from device_ms's profiler window
        row.update(kernel_ms=time_ms(lambda: la.attn_wrap(*args)),
                   device_ms=device_ms(lambda: la.attn_wrap(*args), "daclip::wrap::",
                                       split=split),
                   plain_ms=time_ms(lambda: la.attn_wrap_reference(*args)),
                   bound_ms=bms, bound_by=by, library_ms=None, split=split)
        if dtype == torch.bfloat16:
            row["resources"] = linattn_resources("fwd", C, 0)
    emit(**row)
    what = f"wrap {B, n, C, dtype}" + (" balanced" if balanced else "")
    check(torch.isfinite(got).all().item(), f"{what} not finite")
    check(repeats, f"{what}: two calls differ")
    check(row["max_abs_err"] <= limit, f"{what} max err {row['max_abs_err']}")
    if dtype == torch.bfloat16:
        check(row["mean_abs_err"] <= WRAP_MEAN_LIMIT_BF16,
              f"{what} mean err {row['mean_abs_err']}")
    if balanced:
        check(row["attention_share"] >= SIGNAL_MIN,
              f"{what}: the attention's share {row['attention_share']} is too small")
    return row


def flash_check(B, N, H, D, dtype, train, gen, phase="kernels", path=None):
    """The flash forward at one shape against its plain version (twice, the
    bytes must repeat), keeping the lse as training does when `train`, with
    SDPA's event and device ms beside it; its row."""
    from daclip_torch.ops import flash_attention as fa

    q, k, v = [torch.randn(B, N, H * D, generator=gen, device="cuda").to(dtype)
               for _ in range(3)]
    # serving calls the forward alone, training keeps each query's lse
    fwd = ((lambda: fa._forward_kernel(q, k, v, H, D, True)) if train
           else (lambda: (fa.flash_self_attention(q, k, v, H, D), None)))
    got, lse = fwd()
    torch.cuda.synchronize()
    again, lse2 = fwd()
    repeats = torch.equal(got, again) and (lse is None or torch.equal(lse, lse2))
    want = fa.attention_reference(q.float(), k.float(), v.float(), H, D)
    err = rel_err(got, want)
    limit = LIMITS[("flash", dtype)]
    heads = lambda t: t.view(B, N, H, D).transpose(1, 2)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        heads(q), heads(k), heads(v))
    bms, by = bound_ms(4 * B * N * H * D * q.element_size(), 4 * B * H * N * N * D, dtype)
    row = dict(phase=phase, kernel="flash_self_attention", shape=[B, N, H, D],
               dtype=str(dtype).split(".")[-1], path=path or ("train" if train else "serve"),
               max_rel_err=err, max_abs_err=float((got.float() - want).abs().max()),
               limit=limit, repeats_bitwise=repeats,
               kernel_ms=time_ms(fwd), device_ms=device_ms(fwd, "daclip::flash::"),
               plain_ms=time_ms(lambda: fa.attention_reference(q, k, v, H, D)),
               bound_ms=bms, bound_by=by, library_ms=time_ms(lib),
               library_device_ms=device_ms(lib, ""))
    row.update(over_library=row["device_ms"] / row["library_device_ms"],
               exp_floor_ms=B * H * N * N / EXP_PER_S * 1e3)
    if dtype == torch.bfloat16:
        row["resources"] = flash_resources("fwd", D)
    if lse is not None:
        qh, kh = heads(q.float()), heads(k.float())
        want_lse = torch.logsumexp(qh @ kh.transpose(-1, -2) * D ** -0.5, dim=-1)
        row["lse_max_abs_err"] = float((lse - want_lse).abs().max())
        check(row["lse_max_abs_err"] <= LSE_LIMIT,
              f"flash {B, N, H, D, dtype} lse err {row['lse_max_abs_err']}")
    emit(**row)
    check(err <= limit, f"flash {B, N, H, D, dtype} rel err {err}")
    check(repeats, f"flash {B, N, H, D, dtype}: two calls differ")
    return row


def run_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {"wrap": [], "flash": []}
    for (B, n, C, dtype), balanced in [(s, b) for s in WRAP_SHAPES for b in (False, True)]:
        rows["wrap"].append(wrap_check(B, n, C, dtype, gen, balanced))
    for (B, N, H, D, dtype), train in ([(s, False) for s in FLASH_SHAPES]
                                       + [(s, True) for s in FLASH_TRAIN_SHAPES]):
        rows["flash"].append(flash_check(B, N, H, D, dtype, train, gen))
    for (B, n, C, dtype), balanced in [(s, b) for s in SHARD_WRAP_SHAPES for b in (False, True)]:
        rows["wrap"].append(wrap_check(B, n, C, dtype, gen, balanced, path="shard_tiles"))
    for (B, n, C, dtype), balanced in [(s, b) for s in WRAP_WIDTH_SHAPES for b in (False, True)]:
        rows["wrap"].append(wrap_check(B, n, C, dtype, gen, balanced, path="width",
                                       timed=False))
    for B, N, H, D, dtype in SHARD_FLASH_SHAPES:
        rows["flash"].append(flash_check(B, N, H, D, dtype, False, gen, path="shard_tiles"))
    for B, N, H, D, dtype in FLASH_EDGE_SHAPES:
        rows["flash"].append(flash_check(B, N, H, D, dtype, True, gen, path="edge"))
    return rows


# -- phase 2b ------------------------------------------------------------------
def fused_share(want, b_out, g_out):
    """Mean |plain output − the plain output with the attention left out|,
    without a residual."""
    from daclip_torch.ops.linear_attention import _channel_ln

    return float((want - _channel_ln(b_out.expand_as(want), g_out)).abs().mean())


def linattn_bound(B, n, C, esize, dtype):
    """The bound of the wrap's math on (B, n, C): x in, out out, the weights
    once; 2·B·n·(512·C + 8192) FLOP (q/k/v, ctx, ·W, to_out)."""
    nbytes = (2 * B * n * C + C * 384 + 128 * C + 3 * C) * esize
    return bound_ms(nbytes, 2 * B * n * (512 * C + 8192), dtype)


def run_kernels_alt():
    """The kernels of the UNet's other wirings against their plain versions."""
    from daclip_torch.ops import linear_attention as la
    from daclip_torch.ops import pointwise as pw

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {"fused_v4": [], "wrap_fused": [], "core": [], "dual": []}
    kernels = {  # key → (name, kernel, plain, takes the raw x)
        "fused_v4": ("linear_attention_fused", la.linear_attention_fused,
                     la.fused_composition_reference, False),
        "wrap_fused": ("attn_wrap_fused", la.attn_wrap_fused, la.attn_wrap_reference, True),
        "wrap_fused_xn": ("attn_wrap_fused", lambda xn, *w: la.attn_wrap_fused(
            xn, None, *w, prenorm_residual=False), la.fused_composition_reference, False)}
    cases = ([(s, b, not b) for s in WRAP_SHAPES for b in (False, True)]
             + [(s, b, False) for s in WRAP_WIDTH_SHAPES for b in (False, True)])
    for (B, n, C, dtype), balanced, timed in cases:
        x, g_pre, *w = wrap_case(B, n, C, dtype, gen, balanced)
        xn = la._channel_ln(x, g_pre)
        for key, (name, kernel, plain, raw) in kernels.items():
            args = [x, g_pre, *w] if raw else [xn, *w]
            got = kernel(*args)
            torch.cuda.synchronize()
            repeats = torch.equal(kernel(*args), got)
            fargs = [a.float() for a in args]
            want = plain(*fargs)
            err = (got.float() - want).abs()
            share = (attention_share(want, fargs[0], fargs[-2], fargs[-1]) if raw
                     else fused_share(want, fargs[-2], fargs[-1]))
            limit = LIMITS[("wrap", dtype)]
            row = dict(phase="kernels_alt", kernel=name, shape=[B, n, C],
                       dtype=str(dtype).split(".")[-1], balanced=balanced,
                       prenorm_residual=raw if name == "attn_wrap_fused" else None,
                       max_abs_err=float(err.max()), mean_abs_err=float(err.mean()),
                       limit=limit, repeats_bitwise=repeats, attention_share=share)
            if timed:
                bms, by = linattn_bound(B, n, C, x.element_size(), dtype)
                split = {}
                row.update(kernel_ms=time_ms(lambda: kernel(*args)),
                           device_ms=device_ms(lambda: kernel(*args), "daclip::wrap::",
                                               split=split),
                           plain_ms=time_ms(lambda: plain(*args)),
                           bound_ms=bms, bound_by=by, library_ms=None, split=split)
                if dtype == torch.bfloat16:
                    row["resources"] = linattn_resources("fwd", C, 0 if raw else 1)
            emit(**row)
            rows["fused_v4" if key == "fused_v4" else "wrap_fused"].append(row)
            what = f"{name} {B, n, C, dtype}" + (" raw x" if raw else "") + (
                " balanced" if balanced else "")
            check(torch.isfinite(got).all().item(), f"{what} not finite")
            check(repeats, f"{what}: two calls differ")
            check(row["max_abs_err"] <= limit, f"{what} max err {row['max_abs_err']}")
            if dtype == torch.bfloat16:
                check(row["mean_abs_err"] <= WRAP_MEAN_LIMIT_BF16,
                      f"{what} mean err {row['mean_abs_err']}")
            if balanced:
                check(share >= SIGNAL_MIN, f"{what}: the attention's share {share} is too small")
            del got, want, err, fargs

    # the attention core: its path is one call at each of the six sites
    # (down0 and up0 share the first shape), counted from 0; then the ragged
    # and f32 cases
    qkvs = []
    for B, n, C, dtype in WRAP_SHAPES:
        x, g_pre, w_qkv, *_ = wrap_case(B, n, C, dtype, gen, False)
        qkvs.append((la._channel_ln(x, g_pre) @ w_qkv).contiguous())
    la.linear_attention.launches = 0
    outs = [la.linear_attention(q) for q in qkvs[:1] + qkvs[:5]][1:]
    torch.cuda.synchronize()
    core_path = la.linear_attention.launches
    check(core_path == 6, f"core path launched {core_path} times, expected 6")
    outs += [la.linear_attention(q) for q in qkvs[5:]]
    for qkv, got in zip(qkvs, outs):
        B, n, _ = qkv.shape
        dtype = qkv.dtype
        repeats = torch.equal(la.linear_attention(qkv), got)
        want = la.linear_attention_reference(qkv.float())
        err = float((got.float() - want).abs().max() / want.abs().max())
        limit = LIMITS[("core", dtype)]
        esize = qkv.element_size()
        bms, by = bound_ms(B * n * (384 + 128) * esize, 2 * B * n * 8192, dtype)
        split = {}
        row = dict(phase="kernels_alt", kernel="linear_attention", shape=[B, n, 384],
                   dtype=str(dtype).split(".")[-1], max_rel_err=err,
                   max_abs_err=float((got.float() - want).abs().max()), limit=limit,
                   repeats_bitwise=repeats,
                   kernel_ms=time_ms(lambda: la.linear_attention(qkv)),
                   device_ms=device_ms(lambda: la.linear_attention(qkv), "daclip::wrap::",
                                       split=split),
                   plain_ms=time_ms(lambda: la.linear_attention_reference(qkv)),
                   bound_ms=bms, bound_by=by, library_ms=None, split=split)
        if dtype == torch.bfloat16:
            row["resources"] = linattn_resources("fwd", 384, 2)
        emit(**row)
        rows["core"].append(row)
        check(torch.isfinite(got).all().item(), f"core {B, n, dtype} not finite")
        check(err <= limit, f"core {B, n, dtype} rel err {err}")
        check(repeats, f"core {B, n, dtype}: two calls differ")
    del qkvs, outs

    for R, cx, cs, O, dtype in DUAL_SHAPES:
        rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
        x, skip, w = rnd(R, cx), rnd(R, cs), rnd(cx + cs, O) * (cx + cs) ** -0.5
        xcat = torch.cat([x, skip], dim=1)
        for form, args in (("dual", (x, skip, w)), ("single", (xcat, None, w))):
            got = pw.dual_conv1x1(*args)
            torch.cuda.synchronize()
            repeats = torch.equal(pw.dual_conv1x1(*args), got)
            want = pw.dual_conv1x1_reference(*[None if a is None else a.float() for a in args])
            err = float((got.float() - want).abs().max() / want.abs().max())
            limit = LIMITS[("dual", dtype)]
            bms, by = bound_ms((R * (cx + cs) + R * O + (cx + cs) * O) * x.element_size(),
                               2 * R * (cx + cs) * O, dtype)
            lib = (lambda: torch.matmul(xcat, w)) if form == "single" else None
            row = dict(phase="kernels_alt", kernel="dual_conv1x1", form=form,
                       shape=[R, cx, cs, O], dtype=str(dtype).split(".")[-1],
                       max_rel_err=err, max_abs_err=float((got.float() - want).abs().max()),
                       limit=limit, repeats_bitwise=repeats,
                       kernel_ms=time_ms(lambda: pw.dual_conv1x1(*args)),
                       device_ms=device_ms(lambda: pw.dual_conv1x1(*args), "daclip::pointwise::"),
                       plain_ms=time_ms(lambda: pw.dual_conv1x1_reference(*args)),
                       bound_ms=bms, bound_by=by, library_ms=lib and time_ms(lib),
                       library_device_ms=lib and device_ms(lib, ""))
            if dtype == torch.bfloat16:
                row["resources"] = (dual_resources(R, cx, cs, O) if form == "dual"
                                    else dual_resources(R, cx + cs, 0, O))
            emit(**row)
            rows["dual"].append(row)
            check(torch.isfinite(got).all().item(), f"dual_conv1x1 {form} {R, cx, cs, O} "
                  "not finite")
            check(err <= limit, f"dual_conv1x1 {form} {R, cx, cs, O, dtype} rel err {err}")
            check(repeats, f"dual_conv1x1 {form} {R, cx, cs, O, dtype}: two calls differ")

    # the training step's shapes (B=16): linear_attention_fused at the five
    # (n, C) of the six sites, production-like and balanced, and the single
    # form the UNet calls at 16× the res_conv rows. attn_wrap_fused launches
    # the v5 wrap's forward or linear_attention_fused's, both held here or
    # in kernels_bwd at B=16.
    for (B, n, C, dtype), balanced in [(s, b) for s in TRAIN_WRAP_SHAPES for b in (False, True)]:
        x, g_pre, *w = wrap_case(B, n, C, dtype, gen, balanced)
        args = [la._channel_ln(x, g_pre), *w]
        del x, g_pre
        got = la.linear_attention_fused(*args)
        torch.cuda.synchronize()
        repeats = torch.equal(la.linear_attention_fused(*args), got)
        fargs = [a.float() for a in args]
        want = la.fused_composition_reference(*fargs)
        err = (got.float() - want).abs()
        share = fused_share(want, fargs[-2], fargs[-1])
        limit = LIMITS[("wrap", dtype)]
        row = dict(phase="kernels_alt", kernel="linear_attention_fused", path="train",
                   shape=[B, n, C], dtype=str(dtype).split(".")[-1], balanced=balanced,
                   max_abs_err=float(err.max()), mean_abs_err=float(err.mean()),
                   limit=limit, repeats_bitwise=repeats, attention_share=share)
        if not balanced:
            bms, by = linattn_bound(B, n, C, args[0].element_size(), dtype)
            split = {}
            row.update(kernel_ms=time_ms(lambda: la.linear_attention_fused(*args), iters=10),
                       device_ms=device_ms(lambda: la.linear_attention_fused(*args),
                                           "daclip::wrap::", split=split),
                       plain_ms=time_ms(lambda: la.fused_composition_reference(*args),
                                        iters=5, warmup=1),
                       bound_ms=bms, bound_by=by, library_ms=None, split=split,
                       resources=linattn_resources("fwd", C, 1))
        emit(**row)
        rows["fused_v4"].append(row)
        what = f"linear_attention_fused {B, n, C, dtype}" + (" balanced" if balanced else "")
        check(torch.isfinite(got).all().item(), f"{what} not finite")
        check(repeats, f"{what}: two calls differ")
        check(row["max_abs_err"] <= limit, f"{what} max err {row['max_abs_err']}")
        check(row["mean_abs_err"] <= WRAP_MEAN_LIMIT_BF16,
              f"{what} mean err {row['mean_abs_err']}")
        if balanced:
            check(share >= SIGNAL_MIN, f"{what}: the attention's share {share} is too small")
        del got, want, err, fargs, args
        torch.cuda.empty_cache()

    for R, cx, cs, O, dtype in TRAIN_DUAL_SHAPES:
        K = cx + cs
        x = torch.randn(R, K, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(K, O, generator=gen, device="cuda") * K ** -0.5).to(dtype)
        got = pw.dual_conv1x1(x, None, w)
        torch.cuda.synchronize()
        repeats = torch.equal(pw.dual_conv1x1(x, None, w), got)
        want = pw.dual_conv1x1_reference(x.float(), None, w.float())
        abs_err = float((got.float() - want).abs().max())
        err = abs_err / float(want.abs().max())
        limit = LIMITS[("dual", dtype)]
        bms, by = bound_ms((R * K + R * O + K * O) * x.element_size(), 2 * R * K * O, dtype)
        row = dict(phase="kernels_alt", kernel="dual_conv1x1", form="single", path="train",
                   shape=[R, cx, cs, O], dtype=str(dtype).split(".")[-1], max_rel_err=err,
                   max_abs_err=abs_err, limit=limit, repeats_bitwise=repeats,
                   kernel_ms=time_ms(lambda: pw.dual_conv1x1(x, None, w), iters=10),
                   device_ms=device_ms(lambda: pw.dual_conv1x1(x, None, w),
                                       "daclip::pointwise::"),
                   plain_ms=time_ms(lambda: pw.dual_conv1x1_reference(x, None, w), iters=10),
                   bound_ms=bms, bound_by=by,
                   library_ms=time_ms(lambda: torch.matmul(x, w), iters=10),
                   library_device_ms=device_ms(lambda: torch.matmul(x, w), ""),
                   resources=dual_resources(R, K, 0, O))
        emit(**row)
        rows["dual"].append(row)
        check(torch.isfinite(got).all().item(), f"dual_conv1x1 single {R, K, O} not finite")
        check(err <= limit, f"dual_conv1x1 single {R, K, O, dtype} rel err {err}")
        check(repeats, f"dual_conv1x1 single {R, K, O, dtype}: two calls differ")
        del x, w, got, want
    return rows, core_path


# -- phase 2c ------------------------------------------------------------------
def run_kernels_conv():
    """conv3x3 against its plain version (in f32 on the same inputs) at every
    shape of CONV_SHAPES, and against itself (a second call on the same
    inputs must give the same bytes); cuDNN's conv2d on the free
    channels_last NCHW view of the same x, with the weight in (O, C, 3, 3), is
    the yardstick (timed here only). Then the device times of both summed over
    the 44 sites of one serving forward (B=1 rows at their site counts). Its
    path here is the first call at each shape, counted."""
    from daclip_torch.ops.conv3x3 import conv3x3, conv3x3_reference

    gen = torch.Generator(device="cuda").manual_seed(4)
    rows, path = [], 0
    for B, H, W, C, O, dtype in CONV_SHAPES:
        x = torch.randn(B, H, W, C, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(3, 3, C, O, generator=gen, device="cuda") * (9 * C) ** -0.5).to(dtype)
        before = conv3x3.launches
        got = conv3x3(x, w)
        torch.cuda.synchronize()
        path += conv3x3.launches - before
        repeats = torch.equal(conv3x3(x, w), got)
        want = conv3x3_reference(x.float(), w.float())
        abs_err = float((got.float() - want).abs().max())
        err = abs_err / float(want.abs().max())
        limit = LIMITS[("conv", dtype)]
        x_nchw = x.permute(0, 3, 1, 2)
        w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        lib = lambda: torch.nn.functional.conv2d(x_nchw, w_oihw, padding=1)
        lib_err = rel_err(lib().permute(0, 2, 3, 1), want)
        iters = 10 if B * H * W >= 2 ** 20 else 20
        bms, by = bound_ms((B * H * W * (C + O) + 9 * C * O) * x.element_size(),
                           2 * B * H * W * 9 * C * O, dtype)
        row = dict(phase="kernels_conv", kernel="conv3x3", shape=[B, H, W, C, O],
                   dtype=str(dtype).split(".")[-1], max_rel_err=err, max_abs_err=abs_err,
                   limit=limit, repeats_bitwise=repeats,
                   kernel_ms=time_ms(lambda: conv3x3(x, w), iters=iters),
                   device_ms=device_ms(lambda: conv3x3(x, w), "daclip::conv3x3::"),
                   plain_ms=time_ms(lambda: conv3x3_reference(x, w), iters=iters),
                   bound_ms=bms, bound_by=by, library_ms=time_ms(lib, iters=iters),
                   library_device_ms=device_ms(lib, ""), library_max_rel_err=lib_err)
        if dtype == torch.bfloat16:
            row["resources"] = conv_resources(B, H, W, C, O)
        emit(**row)
        rows.append(row)
        check(torch.isfinite(got).all().item(), f"conv3x3 {B, H, W, C, O} not finite")
        check(err <= limit, f"conv3x3 {B, H, W, C, O, dtype} rel err {err}")
        check(repeats, f"conv3x3 {B, H, W, C, O, dtype}: two calls differ")
        del x, w, got, want, x_nchw, w_oihw
    torch.cuda.empty_cache()
    check(path == len(CONV_SHAPES), f"conv3x3 path launched {path} times, "
          f"expected {len(CONV_SHAPES)}")
    # one serving forward's 44 sites: the B=1 rows at their site counts
    sites = {(H, C, O): n for H, C, O, n in CONV_SITES}
    per_site = [(sites[(r["shape"][1], *r["shape"][3:])], r) for r in rows
                if r["shape"][0] == 1 and r["dtype"] == "bfloat16"
                and (r["shape"][1], *r["shape"][3:]) in sites][:len(CONV_SITES)]
    total = {key: sum(n * r[key] for n, r in per_site)
             for key in ("device_ms", "library_device_ms", "bound_ms")}
    emit(phase="kernels_conv_sum", what="device ms summed over the 44 3x3 sites of one "
         "serving forward (B=1, 256x256), each shape's row times its site count",
         sites=sum(n for n, _ in per_site), kernel_device_ms=total["device_ms"],
         cudnn_device_ms=total["library_device_ms"], bound_ms=total["bound_ms"],
         kernel_over_cudnn=total["device_ms"] / total["library_device_ms"])
    check(sum(n for n, _ in per_site) == CONV_SITES_PER_FORWARD, "site counts")
    return {"conv3x3": rows}, path


# -- phase 3 -------------------------------------------------------------------
def run_fixture():
    from daclip_torch.convert import infer_unet_arch, load_torch_state_dict
    from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config
    from daclip_torch.models.unet import ConditionalUNet
    from daclip_torch.sde import IRSDE

    meta = json.loads((FIXTURE / "meta.json").read_text())
    arrs = np.load(FIXTURE / "arrays.npz")
    daclip = DaCLIP(CLIPCfg.from_dict(get_model_config(meta["model_name"])))
    daclip.load_state_dict(load_torch_state_dict(str(FIXTURE / "daclip.pt")), strict=True)
    daclip.cuda().eval()
    sd = load_torch_state_dict(str(FIXTURE / "unet.pth"))
    arch = {k: v for k, v in infer_unet_arch(sd).items() if k not in ("in_nc", "out_nc")}
    sde = IRSDE(max_sigma=meta["max_sigma"], T=meta["T"], schedule=meta["schedule"],
                eps=meta["eps"])
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3))).cuda()
    with torch.no_grad():
        img_ctx, degra_ctx = daclip.encode_image(dev(arrs["img4clip"][None]), control=True)
    # the kernels each wiring must run (flash at the SpatialTransformers)
    wirings = {"v5": ({}, ("wrap", "flash")),
               "v4_pointwise": (ALT_CONFIGS["v4_pointwise"], ("fused_v4", "dual", "flash")),
               "v3_pointwise": (ALT_CONFIGS["v3_pointwise"], ("wrap_fused", "dual", "flash"))}
    for wiring, (config, need) in wirings.items():
        unet = ConditionalUNet(**arch, **config)
        unet.load_state_dict(sd, strict=True)
        unet.cuda().eval()
        reset_counts()
        with torch.no_grad():
            out = sde.reverse_posterior(unet, dev(arrs["x_T"][None]), dev(arrs["lq"][None]),
                                        noises=dev(arrs["noises"]), text_context=degra_ctx,
                                        image_context=img_ctx)
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_counts().items() if v}
        ours = out[0].cpu().numpy().transpose(1, 2, 0)
        row = dict(phase="fixture", wiring=wiring, psnr_vs_ref_out=psnr(ours, arrs["ref_out"]),
                   psnr_vs_gt=psnr(ours, arrs["gt"]), ref_psnr_vs_gt=meta["ref_psnr_vs_gt"],
                   launches=counts)
        emit(**row)
        check(row["psnr_vs_ref_out"] > 40.0, f"fixture replay ({wiring}) below 40 dB vs ref_out")
        check(set(counts) == set(need), f"fixture replay ({wiring}) launched {counts}, "
              f"expected exactly {need}")


# -- phase 3b ------------------------------------------------------------------
ORBAX_FIXTURE = REPO / "tests" / "fixtures" / "orbax"


def _orbax_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _orbax_leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _orbax_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def run_orbax():
    """Phase 3b: daclip_tpu's orbax train dirs read and served on the
    card's machine, where no JAX is installed."""
    import hashlib

    from daclip_torch.models.unet import CrossAttention, LinearAttention
    from daclip_torch.pipeline import DACLIPRestorer, RestorerConfig
    from daclip_torch.utils import native_checkpoint as nc
    from daclip_torch.utils import orbax_reader, zstd

    started = time.perf_counter()
    blocked = [m for m in ("jax", "orbax", "tensorstore", "zstandard") if m in sys.modules]
    check(not blocked, f"orbax phase: {blocked} imported")
    t0 = time.perf_counter()
    zstd.load()
    build_s = time.perf_counter() - t0
    stored = json.loads((ORBAX_FIXTURE / "leaves.json").read_text())
    leaves = {}
    for name in ("restoration", "daclip"):
        t0 = time.perf_counter()
        tree, step = nc.load_train_tree(str(ORBAX_FIXTURE / name))
        tree_ms = (time.perf_counter() - t0) * 1e3
        got = dict(_orbax_leaves(tree))
        check(set(got) == set(stored[name]), f"orbax {name}: leaves differ from the stored ones")
        for key, leaf in got.items():
            want = stored[name][key]
            if "scalar" in want:
                check(leaf == want["scalar"], f"orbax {name}: {key} = {leaf!r}")
                continue
            raw = leaf.contiguous().view(-1).view(torch.uint8).numpy().tobytes()
            check(str(leaf.dtype).replace("torch.", "") == want["dtype"]
                  and list(leaf.shape) == want["shape"]
                  and hashlib.sha256(raw).hexdigest() == want["sha256"],
                  f"orbax {name}: {key} is not daclip_tpu's leaf bit for bit")
        leaves[name] = dict(step=step, leaves=len(got), tree_ms=tree_ms)
    expected = np.load(ORBAX_FIXTURE / "expected.npz")
    cfg = RestorerConfig(model_name="daclip_test-tiny", T=int(expected["T"]), dtype="float32")
    t0 = time.perf_counter()
    restorer = DACLIPRestorer.load(str(ORBAX_FIXTURE / "restoration"),
                                   str(ORBAX_FIXTURE / "daclip"), cfg, device="cuda")
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3))).cuda()
    reset_counts()
    with torch.no_grad():
        img_ctx, degra_ctx = restorer.contexts(expected["lq"])
        out = restorer.sde.reverse_posterior(restorer.unet, dev(expected["x_T"]),
                                             dev(expected["lq"][None]),
                                             noises=dev(expected["noises"]),
                                             text_context=degra_ctx, image_context=img_ctx)
    torch.cuda.synchronize()
    counts = read_counts()
    ours = out[0].cpu().numpy().transpose(1, 2, 0)
    db = psnr(ours, expected["ref_out"])
    check(np.isfinite(ours).all() and ours.shape == (32, 32, 3), "orbax restore: bad output")
    check(db > 40.0, f"orbax restore {db:.2f} dB against daclip_tpu's stored restore")
    # one UNet call a step: #1 at each LinearAttention, #2 at each
    # SpatialTransformer's self-attention, and nothing else
    modules = dict(restorer.unet.named_modules())
    sites = {"wrap": sum(isinstance(m, LinearAttention) for m in modules.values()),
             "flash": sum(isinstance(m, CrossAttention) and k.endswith("attn1")
                          for k, m in modules.items())}
    need = {k: int(expected["T"]) * v for k, v in sites.items() if v}
    check({k: v for k, v in counts.items() if v} == need,
          f"orbax restore launched {counts}, expected exactly {need}")
    # the decoder alone on the fixture's largest stored chunk
    best = None
    for name in ("restoration", "daclip"):
        d = ORBAX_FIXTURE / name
        item = d / str(orbax_reader.latest_step(str(d))) / "default"
        with orbax_reader.OcdbtStore(str(item)) as store:
            entries = store.entries()
            for key, value in entries.items():
                if key.endswith(b"/.zarray") or not isinstance(value, tuple):
                    continue
                if best is None or value[2] > best[1][2]:
                    meta = json.loads(entries[key.rsplit(b"/", 1)[0] + b"/.zarray"])
                    best = (f"{name}:{key.decode()}", value, store.read_range(*value), meta)
    key, value, raw, meta = best
    nbytes = int(np.prod(meta["chunks"])) * orbax_reader._DTYPES[meta["dtype"]].itemsize
    dst = torch.empty(nbytes, dtype=torch.uint8)
    decode_ms = host_ms(lambda: zstd.decompress_into(raw, dst), iters=100)
    emit(phase="orbax", seconds=time.perf_counter() - started, zstd_build_s=build_s,
         trees=leaves, load_ms=load_ms, psnr_vs_daclip_tpu=db,
         launches={k: v for k, v in counts.items() if v},
         largest_chunk=dict(key=key, stored_bytes=len(raw), decoded_bytes=nbytes,
                            decode_ms=decode_ms, decode_mb_s=nbytes / decode_ms / 1e3))
    return counts


# -- phase 3c ------------------------------------------------------------------
RESUME_STEPS = 2   # steps of the CLI resumed from restoration_full/ (at 1000)
CLI_TYPES = ["noisy", "rainy"]   # the restoration CLIs' MD tree's degradation types
_CLI_INPUTS = {}


def cli_inputs():
    """(MD tree, DA-CLIP .pt) that the restoration CLI phases (resume,
    train_cli) train on, written once a run into a directory that lasts as
    long as the process: CLI_TYPES × 8 seeded pairs at CLI_MD_SHAPE (half Up,
    half Paeth rows), and a seeded ViT-B-32 DA-CLIP's state dict."""
    from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config

    if not _CLI_INPUTS:
        work = tempfile.TemporaryDirectory()
        root = pathlib.Path(work.name)
        write_md_tree(root / "train", CLI_TYPES, 8, CLI_MD_SHAPE, seed=21)
        clip_cfg = CLIPCfg.from_dict(get_model_config("daclip_ViT-B-32"))
        daclip_pt = root / "daclip_ViT-B-32.pt"
        torch.save({k: v.cpu() for k, v in seeded_state_dict(lambda: DaCLIP(clip_cfg),
                                                             seed=12).items()}, daclip_pt)
        _CLI_INPUTS.update(work=work, train=root / "train", daclip=daclip_pt)
    return _CLI_INPUTS["train"], _CLI_INPUTS["daclip"]


def _same_payload(got, want, skip=()):
    """The keys of two `.pt`-style payloads (nested dicts of tensors and
    numbers) that differ, bit for bit; keys in `skip` must be zeros in
    `got`."""
    bad = []

    def walk(g, w, path):
        if isinstance(w, dict):
            if not isinstance(g, dict) or set(g) != set(w):
                bad.append(path)
                return
            for k in w:
                walk(g[k], w[k], f"{path}.{k}")
        elif torch.is_tensor(w):
            if any(path.endswith(f".{k}") for k in skip):
                if not (torch.is_tensor(g) and not torch.count_nonzero(g)):
                    bad.append(path)
            elif not (torch.is_tensor(g) and g.dtype == w.dtype and torch.equal(g, w)):
                bad.append(path)
        elif isinstance(w, list):
            if not isinstance(g, list) or len(g) != len(w):
                bad.append(path)
                return
            for i, (a, b) in enumerate(zip(g, w)):
                walk(a, b, f"{path}.{i}")
        elif g != w:
            bad.append(path)

    walk(got, want, "")
    return bad


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


@contextlib.contextmanager
def recorded_writes(out):
    """While the block runs, each `orbax_writer.save_checkpoint` appends to
    `out` {directory, step, wait, call_ms (what it held its caller: the copy
    to the host when it does not wait), write_ms (its step dir's build and
    write, in the writer process when it does not wait, timed by the thread
    that waits for it), bytes}; the last two are filled in on leaving."""
    from daclip_torch.utils import orbax_writer

    real = (orbax_writer.save_checkpoint, orbax_writer._write_step,
            orbax_writer._write_step_in_process)
    calls, writes = [], []

    def save(directory, step, tree, max_to_keep=None, wait=True, build=None):
        t = time.perf_counter()
        path = real[0](directory, step, tree, max_to_keep, wait, build)
        calls.append(dict(directory=os.path.abspath(directory), step=int(step), wait=wait,
                          call_ms=(time.perf_counter() - t) * 1e3))
        return path

    def timed(write):
        def run(directory, step, *rest):
            t = time.perf_counter()
            path = write(directory, step, *rest)
            writes.append((os.path.abspath(directory), step, (time.perf_counter() - t) * 1e3))
            return path
        return run

    orbax_writer.save_checkpoint = save
    orbax_writer._write_step, orbax_writer._write_step_in_process = map(timed, real[1:])
    try:
        yield out
        orbax_writer.wait_all()
    finally:
        (orbax_writer.save_checkpoint, orbax_writer._write_step,
         orbax_writer._write_step_in_process) = real
    for c in calls:
        ms = [w[2] for w in writes if w[:2] == (c["directory"], c["step"])]
        step_dir = pathlib.Path(c["directory"]) / str(c["step"])
        out.append(dict(c, write_ms=ms[0] if ms else None,
                        bytes=_dir_bytes(step_dir) if step_dir.is_dir() else None))


def _check_resto_step_dir(ckpt_dir, n, cfg, kw, fresh):
    """The CLI's step dir `n` against its `<n>.pt` (the one-token to_q,
    which daclip_tpu has not, zeros): read back by the port's reader
    through the weight map, bit for bit; with `fresh`, instead, a UNet and
    TrainState restored from each on the CPU (the dir through the same
    reader), bit for bit. Returns the measurements."""
    from daclip_torch.models.unet import ConditionalUNet
    from daclip_torch.train import restoration as trest
    from daclip_torch.utils import checkpoint as tckpt
    from daclip_torch.utils import native_checkpoint as nc

    out = dict(step=n, bytes=_dir_bytes(ckpt_dir / str(n)))
    if not fresh:
        pt = torch.load(tckpt.checkpoint_path(str(ckpt_dir), n), map_location="cpu",
                        weights_only=False)
        t0 = time.perf_counter()
        back = nc.load_restoration_train_state(str(ckpt_dir), n, cfg=cfg)
        read_ms = (time.perf_counter() - t0) * 1e3
        to_q = {k for k in pt["params"] if k.endswith("attn2.to_q.weight")}
        # the optimizer's hyperparameters are the options', not the dir's
        back["opt_state"]["param_groups"] = pt["opt_state"]["param_groups"]
        differ = _same_payload(back, pt, skip=to_q)
        check(not differ, f"resume: step dir {n} read back differs from {n}.pt at {differ[:4]}")
        out.update(read_ms=read_ms, leaves_bitwise=True, to_q_zero=len(to_q))
    else:
        states = []
        for path in (ckpt_dir / str(n), pathlib.Path(tckpt.checkpoint_path(str(ckpt_dir), n))):
            unet = ConditionalUNet(**kw)
            state = trest.init_state(unet, cfg, device="cpu")
            t0 = time.perf_counter()
            tckpt.restore_checkpoint(str(path), unet, state, cfg=cfg)
            states.append(((time.perf_counter() - t0) * 1e3, unet, state))
        (ms_dir, u0, s0), (ms_pt, u1, s1) = states
        p0, p1 = dict(u0.named_parameters()), dict(u1.named_parameters())
        to_q = {k for k in p1 if k.endswith("attn2.to_q.weight")}
        differ = [k for k, v in p1.items() if not torch.equal(p0[k], 0 * v if k in to_q else v)]
        differ += [f"ema {k}" for k, v in s1.ema.params.items()
                   if not torch.equal(s0.ema.params[k], 0 * v if k in to_q else v)]
        st0, st1 = s0.optimizer.state, s1.optimizer.state
        differ += [f"moments {k}" for k, v in p1.items()
                   if (v in st1) != (p0[k] in st0) or v in st1 and _same_payload(
                       dict(st0[p0[k]]), dict(st1[v]))]
        differ += [f"step {a} {b}" for a, b in ((s0.step, s1.step), (s0.ema.step, s1.ema.step))
                   if a != b]
        check(not differ, f"resume: the state restored from step dir {n} differs from "
                          f"{n}.pt's at {differ[:4]}")
        out.update(restore_from_dir_ms=ms_dir, restore_from_pt_ms=ms_pt, state_bitwise=True)
    return out


def run_resume(smi=None):
    """Phase 3c: daclip_tpu's training runs resumed on the card's machine,
    where no JAX is installed. restoration_full/ (configs/daclip-sde/
    train.yml's UNet at full width, daclip_tpu's TrainState at step 1000:
    parameters, AdamW's moments, EMA) restored through
    `utils/checkpoint.restore_checkpoint` (which reads it with
    `native_checkpoint.load_restoration_train_state`) on the CPU and on the
    card, which must agree bit for bit; one f32 update from seeded gradients
    on the card against the CPU's;
    `cli.train_restoration -opt` on the production options resumed from it
    for RESUME_STEPS steps at B = 16, 256², bf16 (validation off), launching
    #1-#4 exactly as many steps' worth, saving at the first step in the
    loop (its step dir in the background) and at the end: each save's `.pt`
    and daclip_tpu's step dir, the dirs read back by the port's reader and
    held bit for bit to the `.pt` of their step through the weight map, a
    fresh state restored from the last dir bit for bit the one restored from
    its `.pt`, the writes' ms and bytes beside the card's name and power
    limit (`smi`); `cli.train_daclip --resume latest` on daclip_tpu's
    daclip_test-tiny checkpoints dir for one epoch, launching none of the
    kernels, its step dir `2/` held to `epoch_2.pt` alike. Returns (the
    resumed restoration CLI's launches, its step records)."""
    import logging
    import shutil

    import yaml

    from daclip_torch.cli import train_daclip as cli_daclip
    from daclip_torch.cli import train_restoration as cli_train
    from daclip_torch.factory import create_model
    from daclip_torch.models.unet import ConditionalUNet
    from daclip_torch.train import clip_train as tclip
    from daclip_torch.train import restoration as trest
    from daclip_torch.utils import checkpoint as tckpt
    from daclip_torch.utils import native_checkpoint as nc
    from daclip_torch.utils import orbax_reader

    if smi is None:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]

    started = time.perf_counter()
    blocked = [m for m in ("jax", "orbax", "tensorstore", "zstandard") if m in sys.modules]
    check(not blocked, f"resume phase: {blocked} imported")
    full = ORBAX_FIXTURE / "restoration_full"
    at = orbax_reader.latest_step(str(full))
    opt = yaml.safe_load((REPO / "configs" / "daclip-sde" / "train.yml").read_text())
    kw = cli_train.unet_kwargs(opt)
    cfg = cli_train.train_config(opt["train"], int(opt["train"]["niter"]))

    # the state restored on the CPU and on the card, as the CLI restores it
    host = ConditionalUNet(**kw)
    hstate = trest.init_state(host, cfg, device="cpu")
    t0 = time.perf_counter()
    tckpt.restore_checkpoint(str(full), host, hstate, cfg=cfg)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    unet = ConditionalUNet(dtype=torch.bfloat16, **kw)
    state = trest.init_state(unet, cfg, device="cuda")
    t0 = time.perf_counter()
    tckpt.restore_checkpoint(str(full), unet, state, cfg=cfg)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    named, hosts = dict(unet.named_parameters()), dict(host.named_parameters())
    differ = [n for n, p in named.items() if not torch.equal(p.detach().cpu(), hosts[n])]
    differ += [f"ema {n}" for n, v in hstate.ema.params.items()
               if not torch.equal(state.ema.params[n].cpu(), v)]
    same = lambda a, b: (float(a) == float(b) if b.dim() == 0  # AdamW's step
                         else torch.equal(a.cpu(), b))
    held = [n for n in named if named[n] in state.optimizer.state]
    differ += [f"moments {n}" for n in held
               if hosts[n] not in hstate.optimizer.state
               or set(state.optimizer.state[named[n]]) != set(hstate.optimizer.state[hosts[n]])
               or not all(same(v, hstate.optimizer.state[hosts[n]][k])
                          for k, v in state.optimizer.state[named[n]].items())]
    check(not differ and len(held) == len(hstate.optimizer.state),
          f"resume: the card's state differs from the CPU's at {differ[:4]}")
    check(state.step == state.ema.step == hstate.step == at,
          f"resume: steps {state.step}, {state.ema.step}, {hstate.step}, dir {at}")

    # one f32 update from seeded gradients, on the card and on the CPU (the
    # card's UNet computes in bf16; its parameters and optimizer are f32)
    gen = torch.Generator().manual_seed(7)
    before = {n: p.detach().clone() for n, p in hosts.items()}
    for n, hp in trest.trainable(host):  # none where the model gives no gradient
        g = torch.randn(hp.shape, generator=gen) * 1e-2 if n in held else None
        hp.grad, named[n].grad = g, None if g is None else g.cuda()
    schedule = trest.make_schedule(cfg)
    _, lr_host = trest.apply_gradients(hstate, host, cfg, schedule)
    _, lr_card = trest.apply_gradients(state, unet, cfg, schedule)
    after = {n: p.detach() for n, p in hosts.items()}
    param_err = max(float((named[n].detach().cpu() - p).abs().max()) for n, p in after.items())
    update_max = max(float((p - before[n]).abs().max()) for n, p in after.items())
    update_err = max(float(((named[n].detach().cpu() - before[n]) - (p - before[n])).abs().max())
                     for n, p in after.items())
    ema_err = max(float((state.ema.params[n].cpu() - v).abs().max())
                  for n, v in hstate.ema.params.items())
    update = dict(lr_host=lr_host, lr_card=lr_card, param_max_abs_err=param_err,
                  update_max=update_max, update_max_abs_err=update_err,
                  update_rel_err=update_err / update_max, ema_max_abs_err=ema_err)
    check(lr_host == lr_card and param_err <= 1e-4 and ema_err <= 1e-4
          and update_max > 0 and update_err <= 1e-2 * update_max,
          f"resume: the card's f32 update differs from the CPU's: {update}")
    del unet, state, host, hstate, named, hosts, before, after
    torch.cuda.empty_cache()

    # the CLIs, each resuming daclip_tpu's dir
    t0 = time.perf_counter()
    train_tree, daclip_pt = cli_inputs()
    inputs_s = time.perf_counter() - t0
    records = []
    real_make_step = cli_train.make_step
    logs = []

    class Grab(logging.Handler):
        def emit(self, record):
            logs.append(record.getMessage())

    grab = Grab()
    with tempfile.TemporaryDirectory() as d:
        root = pathlib.Path(d)
        opt["distortion"] = CLI_TYPES
        opt["datasets"]["train"]["dataroot"] = str(train_tree)
        del opt["datasets"]["val"]                # validation off
        opt["path"].update(root=str(root / "out"), daclip=str(daclip_pt))
        opt["train"].update(val_freq=0)
        # one save in the loop (at + 1: its step dir in the background), one at the end
        opt["logger"].update(print_freq=1, save_checkpoint_freq=at + 1)
        yml = root / "train.yml"
        yml.write_text(yaml.safe_dump(opt))
        ckpt_dir = root / "out" / "experiments" / opt["name"] / "training_state"
        shutil.copytree(full, ckpt_dir)
        for name in ("train", "daclip"):
            logging.getLogger(name).addHandler(grab)
            logging.getLogger(name).setLevel(logging.INFO)
        cli_train.make_step = step_timer(real_make_step, records)
        real_save, saves = tckpt.save_checkpoint, []

        def timed_save(*a, **k):  # what a save holds the training loop for
            t = time.perf_counter()
            out = real_save(*a, **k)
            saves.append(dict(wait=k.get("wait", True), call_ms=(time.perf_counter() - t) * 1e3))
            return out

        tckpt.save_checkpoint = timed_save
        writes, clip_writes = [], []
        reset_counts()
        t0 = time.perf_counter()
        try:
            with recorded_writes(writes):
                result = cli_train.main(["-opt", str(yml), "--max-steps",
                                         str(at + RESUME_STEPS), "--device", "cuda"])
            torch.cuda.synchronize()
            counts = {k: v for k, v in read_counts().items() if v}
            cli_s = time.perf_counter() - t0
            saved = sorted(os.listdir(ckpt_dir))
            tckpt.save_checkpoint = real_save
            writes = [dict(w, directory=None) for w in writes
                      if w["directory"] == str(ckpt_dir)]
            t0 = time.perf_counter()
            dirs = [_check_resto_step_dir(ckpt_dir, n, cfg, kw, fresh=n == at + RESUME_STEPS)
                    for n in (at + 1, at + RESUME_STEPS)]
            dirs_check_s = time.perf_counter() - t0

            ckpts = root / "logs" / "run" / "checkpoints"
            shutil.copytree(ORBAX_FIXTURE / "daclip" / "1", ckpts / "1")
            reset_counts()
            t0 = time.perf_counter()
            with recorded_writes(clip_writes):
                clip_out = cli_daclip.main([
                    "--dataset-type", "synthetic", "--train-num-samples", "8", "--batch-size",
                    "4", "--epochs", "2", "--warmup", "1", "--model", "daclip_test-tiny",
                    "--logs", str(root / "logs"), "--name", "run", "--precision", "fp32",
                    "--seed", "0", "--workers", "0", "--device", "cuda", "--resume", "latest"])
            torch.cuda.synchronize()
            clip_s = time.perf_counter() - t0
            clip_counts = {k: v for k, v in read_counts().items() if v}
            clip_saved = torch.load(tckpt.checkpoint_path(str(ckpts), 2, tckpt.EPOCH),
                                    map_location="cpu", weights_only=False)
            # its step dir 2/ (and best/2/) against epoch_2.pt: read back, and restored
            clip_dirs = sorted(os.listdir(ckpts))
            t0 = time.perf_counter()
            clip_back = []
            for path in (ckpts, ckpts / "best"):
                model = create_model("daclip_test-tiny", use_predictor=True)
                back = nc.load_daclip_train_state(str(path), model, 2,
                                                  cfg=tclip.ClipTrainConfig())
                pt = torch.load(tckpt.checkpoint_path(str(path), 2, tckpt.EPOCH),
                                map_location="cpu", weights_only=False)
                back["name"] = pt["name"]  # the run's name: not in the dir
                back["optimizer"]["param_groups"] = pt["optimizer"]["param_groups"]
                clip_back.append(_same_payload(back, pt))
            models = []
            for path in (ckpts / "2", pathlib.Path(tckpt.checkpoint_path(str(ckpts), 2,
                                                                         tckpt.EPOCH))):
                model = create_model("daclip_test-tiny", use_predictor=True, seed=9)
                cstate = tclip.init_state(model, tclip.ClipTrainConfig(), device="cpu")
                tckpt.restore_clip_checkpoint(str(path), model, cstate,
                                              cfg=tclip.ClipTrainConfig())
                models.append((model.state_dict(), cstate.step))
            clip_fresh = [k for k, v in models[1][0].items() if not torch.equal(models[0][0][k], v)]
            clip_fresh += [] if models[0][1] == models[1][1] else ["step"]
            clip_check_s = time.perf_counter() - t0
            clip_writes = [dict(w, directory=os.path.relpath(w["directory"], ckpts))
                           for w in clip_writes]
        finally:
            cli_train.make_step = real_make_step
            tckpt.save_checkpoint = real_save
            for name in ("train", "daclip"):
                logging.getLogger(name).removeHandler(grab)
    want = {"wrap": 12 * RESUME_STEPS, "flash": 6 * RESUME_STEPS,
            "wrap_bwd": 6 * RESUME_STEPS, "flash_bwd": 3 * RESUME_STEPS}
    losses = [r["loss"] for r in records]
    row = dict(phase="resume", seconds=time.perf_counter() - started, step=at,
               restore_cpu_ms=cpu_ms, restore_card_ms=card_ms, state_bitwise=True,
               cli_inputs_s=inputs_s,
               f32_update=update,
               cli=dict(steps=[r["step"] for r in records], ms_per_step=[r["ms"] for r in records],
                        loss=losses, seconds=cli_s, final_step=result["final_step"],
                        checkpoints=saved, launches=counts, want_launches=want),
               daclip_cli=dict(seconds=clip_s, best_loss=clip_out["best_loss"],
                               epoch=clip_saved["epoch"], step=clip_saved["step"],
                               launches=clip_counts, checkpoints=clip_dirs,
                               step_dirs_bitwise=not any(clip_back) and not clip_fresh,
                               writes=clip_writes, check_s=clip_check_s),
               orbax_write=dict(card=smi, saves=saves, writes=writes, dirs=dirs,
                                check_s=dirs_check_s))
    emit(**row)
    check(len(saves) == 2 and [s_["wait"] for s_ in saves] == [False, True]
          and [w["step"] for w in writes] == [at + 1, at + RESUME_STEPS]
          and all(w["bytes"] for w in writes),
          f"resume: the CLI's saves {saves}, step dir writes {writes}")
    check(str(at + 1) in saved and str(at + RESUME_STEPS) in saved,
          f"resume: the CLI wrote no step dirs: {saved}")
    check(not any(clip_back) and not clip_fresh and {"2", "epoch_2.pt"} <= set(clip_dirs),
          f"resume: cli.train_daclip's step dir 2/ differs from epoch_2.pt at "
          f"{clip_back} {clip_fresh[:4]} ({clip_dirs})")
    check(f"resumed from step {at}" in logs
          and any(m.startswith("resumed from daclip_tpu's orbax step dir") for m in logs),
          f"resume: the CLI did not resume daclip_tpu's step {at}: {logs[:6]}")
    check([r["step"] for r in records] == list(range(at, at + RESUME_STEPS))
          and result["final_step"] == at + RESUME_STEPS,
          f"resume: the CLI ran steps {[r['step'] for r in records]}")
    check(np.isfinite(losses).all(), f"resume: losses {losses}")
    check(f"{at + RESUME_STEPS}.pt" in saved, f"resume: the CLI saved {saved}")
    check(counts == want, f"resume: kernel calls {counts}, expected {want}")
    check(any("epoch 1 (daclip_tpu's orbax step dir)" in m for m in logs),
          "resume: cli.train_daclip did not resume daclip_tpu's epoch 1")
    check((clip_saved["epoch"], clip_saved["step"]) == (2, 4)
          and np.isfinite(clip_out["best_loss"]),
          f"resume: cli.train_daclip saved epoch {clip_saved['epoch']} at step "
          f"{clip_saved['step']}")
    check(not clip_counts, f"resume: cli.train_daclip launched {clip_counts}")
    return counts, records


# -- phase 4 -------------------------------------------------------------------
def seeded_state_dict(factory, seed):
    """Reference-named state dict of `factory()` filled from a seed, on the
    card, with no zero tensor: fan-in scaled weights, norm gains near 1,
    small biases. Tensors shared by two names (DaCLIP's visual alias) stay
    shared."""
    with torch.device("meta"):
        module = factory()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out, by_id = {}, {}
    for key, p in module.state_dict(keep_vars=True).items():
        if id(p) not in by_id:
            shape = tuple(p.shape)
            leaf = key.rsplit(".", 1)[-1]
            r = torch.randn(shape, generator=gen, device="cuda")
            if key.endswith(".g") or (leaf == "weight" and len(shape) == 1):
                t = 1 + 0.1 * r
            elif leaf == "logit_scale":
                t = torch.full(shape, float(np.log(1 / 0.07)), device="cuda")
            elif len(shape) >= 2:
                t = r * float(np.prod(shape[1:])) ** -0.5
            else:
                t = 0.02 * r
            by_id[id(p)] = t
        out[key] = by_id[id(p)]
    return out


def run_serve():
    from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config
    from daclip_torch.models.unet import ConditionalUNet
    from daclip_torch.ops import flash_attention as fa
    from daclip_torch.ops import linear_attention as la
    from daclip_torch.pipeline import DACLIPRestorer, RestorerConfig

    # production: ViT-B-32, nf 64, (1,2,4,8), ctx 512, bf16, T=100; the default
    # wiring whatever the DACLIP_TPU_* variables say
    cfg = RestorerConfig(linear_attention="v5", pointwise=False)
    t0 = time.perf_counter()
    unet_sd = seeded_state_dict(lambda: ConditionalUNet(
        nf=cfg.nf, ch_mult=cfg.ch_mult, context_dim=cfg.context_dim,
        use_degra_context=True, use_image_context=True), seed=1)
    daclip_sd = seeded_state_dict(lambda: DaCLIP(CLIPCfg.from_dict(
        get_model_config(cfg.model_name))), seed=2)
    check(all(bool(t.abs().max() > 0) for sd in (unet_sd, daclip_sd) for t in sd.values()),
          "a weight tensor is all zero")
    restorer = DACLIPRestorer(cfg, unet_sd, daclip_sd, device="cuda")
    emit(phase="serve_setup", seconds=time.perf_counter() - t0,
         unet_params=sum(p.numel() for p in restorer.unet.parameters()),
         daclip_params=sum(p.numel() for p in restorer.daclip.parameters()))

    rng = np.random.RandomState(0)
    img = lambda h, w: rng.rand(h, w, 3).astype(np.float32)
    # warm-up: one 256² restore, then one UNet forward at each request's shape
    restorer.restore(img(256, 256), seed=0)
    with torch.no_grad():
        for h, w, b in ((256, 320, 1), (256, 256, 2), (512, 384, 2)):
            x = torch.rand(b, 3, h, w, device="cuda")
            c = torch.rand(b, cfg.context_dim, device="cuda")
            restorer.unet(x, x, torch.full((b,), 50.0, device="cuda"), c, c)
    torch.cuda.synchronize()

    # the first request goes through serve/predictor.py from a PNG on disk to a
    # PNG on disk (the port's own codec; the card's machine needs no cv2 for it)
    from daclip_torch.data import png
    from daclip_torch.serve.predictor import Predictor

    tmp = tempfile.TemporaryDirectory()
    in_png, out_png = os.path.join(tmp.name, "in.png"), os.path.join(tmp.name, "out.png")
    png.write(in_png, (img(256, 256) * 255).round().astype(np.uint8))
    predictor = Predictor()
    predictor.restorer = restorer
    requests = [
        ("predict_png_256x256", lambda: [png.read(predictor.predict(in_png, seed=1,
                                                                    out_path=out_png))],
         [(256, 256, 3)]),
        ("restore_200x300", lambda: [restorer.restore(img(200, 300), seed=2)], [(200, 300, 3)]),
        ("restore_batch_2x256x256",
         lambda: restorer.restore_batch([img(256, 256), img(256, 256)], seed=3),
         [(256, 256, 3)] * 2),
        ("restore_tiled_480x640", lambda: [restorer.restore(img(480, 640), seed=4)],
         [(480, 640, 3)]),
    ]
    steps = restorer.sde.sample_T
    totals = {"wrap": 0, "flash": 0}
    for name, fn, shapes in requests:
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        la.attn_wrap.launches = fa.flash_self_attention.launches = 0
        t0 = time.perf_counter()
        outs = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        wrap_n, flash_n = la.attn_wrap.launches, fa.flash_self_attention.launches
        totals["wrap"] += wrap_n
        totals["flash"] += flash_n
        finite = all(np.isfinite(o.astype(np.float32)).all() for o in outs)
        emit(phase="serve", request=name, latency_ms=ms, sampler_runs=1, steps=steps,
             wrap_launches=wrap_n, flash_launches=flash_n, finite=bool(finite),
             output_shapes=[list(o.shape) for o in outs],
             max_memory_allocated=torch.cuda.max_memory_allocated(),
             memory_allocated_before=resident)
        check([o.shape for o in outs] == shapes, f"{name} output shapes")
        check(finite, f"{name} output not finite")
        check(wrap_n == 6 * steps and flash_n == 3 * steps,
              f"{name}: {wrap_n} wrap / {flash_n} flash launches, expected "
              f"{6 * steps} / {3 * steps} for one {steps}-step sampler run")
    tmp.cleanup()
    return restorer, totals, (unet_sd, daclip_sd)


# -- phase 4b ------------------------------------------------------------------
def run_serve_alt(restorer, sds):
    """The production weights in each other wiring: one full-width bf16 UNet
    forward against the v5 wiring's (limit ALT_FORWARD_FACTOR × the v5 bf16
    forward's max distance from the f32 v5 forward, TF32 off), then two 256²
    requests through DACLIPRestorer with their launch counts and a profile of
    one UNet forward."""
    from daclip_torch.models.unet import ConditionalUNet
    from daclip_torch.pipeline import DACLIPRestorer, RestorerConfig

    unet_sd, daclip_sd = sds
    cfg = restorer.cfg
    gen = torch.Generator(device="cuda").manual_seed(8)
    xt, cond = (torch.rand(1, 3, 256, 256, generator=gen, device="cuda") for _ in range(2))
    c = torch.randn(1, cfg.context_dim, generator=gen, device="cuda")
    t = torch.full((1,), 50.0, device="cuda")
    with torch.no_grad():
        ref = restorer.unet(xt, cond, t, c, c)
        unet32 = ConditionalUNet(nf=cfg.nf, ch_mult=cfg.ch_mult, context_dim=cfg.context_dim,
                                 use_degra_context=True, use_image_context=True)
        unet32.load_state_dict(unet_sd, strict=True)
        out32 = unet32.cuda().eval()(xt, cond, t, c, c)
    del unet32
    floor = float((ref - out32).abs().max())
    limit = ALT_FORWARD_FACTOR * floor
    emit(phase="serve_alt_forward", wiring="v5", max_abs_err_vs_f32=floor,
         mean_abs_err_vs_f32=float((ref - out32).abs().mean()), output_max=float(ref.abs().max()))
    img = np.random.RandomState(5).rand(256, 256, 3).astype(np.float32)
    steps = restorer.sde.sample_T
    totals = {}
    route = {"v4": "fused_v4", "v3": "wrap_fused", "v5": "wrap"}

    def requests(r, wiring, want, n=2, yardstick=False):
        """n 256² requests through `r`, each counted from 0; the v5 ones
        (yardstick) before and after the other wirings bracket them in this
        phase (host time spreads run to run)."""
        for i in range(n):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            reset_counts()
            t0 = time.perf_counter()
            res = r.restore(img, seed=1)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = {k: v for k, v in read_counts().items() if v}
            emit(phase="serve_alt", wiring=wiring, request=f"restore_256x256#{i}",
                 latency_ms=ms, steps=steps, launches=counts,
                 finite=bool(np.isfinite(res).all()), output_shape=list(res.shape),
                 max_memory_allocated=torch.cuda.max_memory_allocated(),
                 memory_allocated_before=resident)
            check(res.shape == (256, 256, 3) and np.isfinite(res).all(),
                  f"{wiring} request output")
            check(counts == want, f"{wiring} request launched {counts}, expected {want}")
            if not yardstick:
                for k, v in counts.items():
                    totals[k] = totals.get(k, 0) + v

    v5_want = {"wrap": 6 * steps, "flash": 3 * steps}
    requests(restorer, "v5", v5_want, yardstick=True)
    for wiring, config in ALT_CONFIGS.items():
        alt = DACLIPRestorer(RestorerConfig(**config), unet_sd, daclip_sd, device="cuda")
        with torch.no_grad():
            out = alt.unet(xt, cond, t, c, c)
        err = float((out - ref).abs().max())
        emit(phase="serve_alt_forward", wiring=wiring, max_abs_err_vs_v5=err,
             mean_abs_err_vs_v5=float((out - ref).abs().mean()),
             max_abs_err_vs_f32=float((out - out32).abs().max()), limit=limit)
        check(bool(torch.isfinite(out).all()), f"{wiring} forward not finite")
        check(err <= limit, f"{wiring} forward differs from v5 by {err} (limit {limit})")
        requests(alt, wiring, {route[config["linear_attention"]]: 6 * steps,
                               "flash": 3 * steps, "dual": 9 * steps})
        run_profile(alt, wiring=wiring)
        del alt, out
        torch.cuda.empty_cache()
    requests(restorer, "v5_after", v5_want, yardstick=True)
    return totals, dict(args=(xt, cond, t, c, c), ref=ref, limit=limit)


# -- phase 4c ------------------------------------------------------------------
def run_forward_conv(unet, fwd):
    """One full-width bf16 v5 UNet forward with every 3×3 stride-1 Conv2d's
    output replaced, through a forward hook registered here, by conv3x3 on
    the module's input (its NHWC view; the bias, where the module has one,
    added outside the kernel). Each site is held against the module's own
    output, the forward against serve_alt's plain one (`fwd`). Returns the
    kernel's launches in that forward."""
    from daclip_torch.ops.conv3x3 import conv3x3, conv3x3_weight

    sites = []

    def substitute(module, inputs, output):
        x = inputs[0]
        xh = x.permute(0, 2, 3, 1)
        copied = not xh.is_contiguous()
        y = conv3x3(xh.contiguous() if copied else xh, conv3x3_weight(module.weight.to(x.dtype)))
        if module.bias is not None:
            y = y + module.bias.to(y.dtype)
        y = y.permute(0, 3, 1, 2)
        sites.append(dict(shape=[*xh.shape, y.shape[1]], copied=copied,
                          max_rel_err=rel_err(y, output)))
        return y

    convs = [m for m in unet.modules() if isinstance(m, torch.nn.Conv2d)
             and m.kernel_size == (3, 3) and m.stride == (1, 1) and m.padding == (1, 1)]
    handles = [m.register_forward_hook(substitute) for m in convs]
    try:
        reset_counts()
        with torch.no_grad():
            out = unet(*fwd["args"])
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_counts().items() if v}
    finally:
        for h in handles:
            h.remove()
    launches = counts.get("conv3x3", 0)
    err = float((out - fwd["ref"]).abs().max())
    limit = LIMITS[("conv", torch.bfloat16)]
    worst = max(s["max_rel_err"] for s in sites)
    emit(phase="forward_conv", sites=len(convs), launches=counts,
         max_abs_err_vs_plain_forward=err, forward_limit=fwd["limit"],
         worst_site_rel_err=worst, site_limit=limit,
         copied_views=sum(s["copied"] for s in sites), per_site=sites)
    check(len(convs) == CONV_SITES_PER_FORWARD,
          f"{len(convs)} 3×3 stride-1 convs, expected {CONV_SITES_PER_FORWARD}")
    counts_by_shape = {}
    for site in sites:  # (1, H, W, C, O) → (H, C, O)
        key = (site["shape"][1], site["shape"][3], site["shape"][4])
        counts_by_shape[key] = counts_by_shape.get(key, 0) + 1
    check(counts_by_shape == {(H, C, O): n for H, C, O, n in CONV_SITES},
          f"the forward's 3×3 sites {counts_by_shape} differ from CONV_SITES")
    check(launches == CONV_SITES_PER_FORWARD,
          f"forward_conv launched conv3x3 {launches} times, expected {CONV_SITES_PER_FORWARD}")
    check(bool(torch.isfinite(out).all()), "forward_conv output not finite")
    check(worst <= limit, f"a conv3x3 site differs from its Conv2d by {worst} of its max")
    check(err <= fwd["limit"], f"forward_conv differs from the plain forward by {err} "
          f"(limit {fwd['limit']})")
    return launches


# -- phase 4d ------------------------------------------------------------------
TEXT_BATCHES = (28, 256, 1024)   # the level prompts, and two prompt banks
TEXT_LIMIT = 1e-4      # f32 on the card vs f32 on the CPU, max abs (the predictor's of its max)
TEXT_COS_MIN = 0.99    # bf16 vs f32 on the card, each text feature's cosine


def run_text(restorer, daclip_sd):
    """DA-CLIP's text side at full width (ViT-B-32: text width 512, 12
    layers, 8 heads, context 77): the serve phase's bf16 DaCLIP, and the
    same weights in f32 on the card (TF32 off) and on the CPU, with seeded
    level-predictor regressors."""
    import dataclasses

    from daclip_torch.data.csv_dataset import build_banks
    from daclip_torch.eval.zero_shot import build_zero_shot_classifier, load_imagenet_metadata
    from daclip_torch.models.clip import DaCLIP, MultiTypeDegradationPredictor
    from daclip_torch.pipeline import DEGRADATION_CLASSES, DACLIPRestorer
    from daclip_torch.tokenizer import _default_tokenizer, tokenize

    model = restorer.daclip
    L = model.cfg.text.context_length
    tok = lambda texts: tokenize(texts, context_length=L)
    reset_counts()
    t0 = time.perf_counter()
    _default_tokenizer()
    load_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cls_toks = tok(DEGRADATION_CLASSES)
    bank, lvl_toks = build_banks(tok)
    tok_ms = (time.perf_counter() - t0) * 1e3
    emit(phase="text", what="tokenize", prompts=len(cls_toks) + len(lvl_toks),
         host_ms=tok_ms, tokenizer_load_ms=load_ms)

    # text_features of the restorer (bf16), cold then cached
    ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        feats_bf16_cls = restorer.text_features(DEGRADATION_CLASSES)
        ms.append((time.perf_counter() - t0) * 1e3)
    emit(phase="text", what="text_features", classes=len(DEGRADATION_CLASSES),
         cold_ms=ms[0], cached_ms=ms[1], shape=list(feats_bf16_cls.shape))
    check(feats_bf16_cls.shape == (10, 512), "text_features shape")

    # encode_text at three batch sizes, bf16
    classnames, templates = load_imagenet_metadata()
    prompts = [t.format(c) for c in classnames for t in templates][:max(TEXT_BATCHES)]
    bank_toks = torch.from_numpy(tok(prompts)).cuda()
    for B in TEXT_BATCHES:
        toks = torch.from_numpy(lvl_toks).cuda() if B == 28 else bank_toks[:B]
        with torch.no_grad():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            out = model.encode_text(toks, normalize=True)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            t = time_ms(lambda: model.encode_text(toks, normalize=True), iters=10)
        emit(phase="text", what="encode_text", batch=B, dtype="bfloat16", median_ms=t,
             prompts_per_s=B / (t / 1e3), max_memory_allocated=peak,
             memory_allocated_before=resident)
        check(out.shape == (B, 512) and bool(torch.isfinite(out).all()),
              f"encode_text at B={B}: shape {tuple(out.shape)} or not finite")

    # classify_degradation on four seeded 256² images, bf16
    rng = np.random.RandomState(5)
    images = [rng.rand(256, 256, 3).astype(np.float32) for _ in range(4)]
    restorer.classify_degradation(images[0])  # warm-up
    ms, top1 = [], []
    for img in images:
        t0 = time.perf_counter()
        name, probs = restorer.classify_degradation(img)
        ms.append((time.perf_counter() - t0) * 1e3)
        top1.append(name)
        check(name in DEGRADATION_CLASSES and abs(sum(probs.values()) - 1) < 1e-3,
              "classify_degradation's result")
    emit(phase="text", what="classify_degradation", images=4, median_ms=float(np.median(ms)),
         ms=ms, top1=top1)

    # DaCLIP(use_predictor=True).forward: 16 images with both banks, bf16
    pred_sd = {f"predictor.{k}": v for k, v in
               seeded_state_dict(MultiTypeDegradationPredictor, seed=3).items()}
    sd = dict(daclip_sd, **pred_sd)
    cfg = model.cfg

    def predictor_model(dtype, device):
        m = DaCLIP(cfg, dtype=dtype, use_predictor=True)
        m.load_state_dict({k: v.to(device) for k, v in sd.items()}, strict=True)
        return m.to(device).eval()

    gen = torch.Generator(device="cuda").manual_seed(6)
    imgs = torch.randn(16, 3, 224, 224, generator=gen, device="cuda")
    banks = dict(all_d_type_tokens=torch.from_numpy(lvl_toks).cuda(),
                 bin_center_bank=torch.from_numpy(bank).cuda())
    pred_bf16 = predictor_model(torch.bfloat16, "cuda")
    with torch.no_grad():
        out = pred_bf16(image=imgs, **banks)
        t = time_ms(lambda: pred_bf16(image=imgs, **banks), iters=10)
    emit(phase="text", what="daclip_forward_predictor", images=16, dtype="bfloat16",
         median_ms=t, pred_shape=list(out["pred"].shape),
         pred_mean=[float(x) for x in out["pred"].float().mean(0)])
    check(out["pred"].shape == (16, 4) and bool(torch.isfinite(out["pred"]).all()),
          "the predictor's output shape or values")
    del pred_bf16

    # build_zero_shot_classifier: the 10 classes × the 80 templates, bf16
    t0 = time.perf_counter()
    clf = build_zero_shot_classifier(lambda t: model.encode_text(t, normalize=True), tok,
                                     DEGRADATION_CLASSES, templates, device="cuda")
    torch.cuda.synchronize()
    emit(phase="text", what="build_zero_shot_classifier", classes=10, templates=len(templates),
         ms=(time.perf_counter() - t0) * 1e3, shape=list(clf.shape))
    check(clf.shape == (512, 10) and bool(torch.isfinite(clf).all()), "the classifier")
    counts = read_counts()
    emit(phase="text", what="hand_kernel_launches", launches=counts)
    check(not any(counts.values()), f"the text path launched hand kernels: {counts}")

    # the card against the port's CPU path, in f32: the 38 prompts' features,
    # the four images' probabilities, the predictor's outputs
    f32cfg = dataclasses.replace(restorer.cfg, dtype="float32")
    unet_sd = restorer.unet.state_dict()
    prompts38 = torch.from_numpy(np.concatenate([cls_toks, lvl_toks]))
    feats, probs, preds = {}, {}, {}
    for device in ("cuda", "cpu"):
        r = DACLIPRestorer(f32cfg, unet_sd, daclip_sd, device=device)
        with torch.no_grad():
            feats[device] = r.daclip.encode_text(prompts38.to(device), normalize=True).cpu()
        probs[device] = np.array([[p[n] for n in DEGRADATION_CLASSES]
                                  for p in (r.classify_degradation(im)[1] for im in images)])
        m = predictor_model(torch.float32, device)
        with torch.no_grad():
            preds[device] = m(image=imgs.to(device),
                              **{k: v.to(device) for k, v in banks.items()})["pred"].cpu()
        del r, m
    with torch.no_grad():
        feats_bf16 = model.encode_text(prompts38.cuda(), normalize=True).float().cpu()
    feat_err = float((feats["cuda"] - feats["cpu"]).abs().max())
    prob_err = float(np.abs(probs["cuda"] - probs["cpu"]).max())
    pred_err = float((preds["cuda"] - preds["cpu"]).abs().max() / preds["cpu"].abs().max())
    cos = torch.nn.functional.cosine_similarity(feats_bf16, feats["cuda"], dim=-1)
    emit(phase="text", what="check", features_f32_card_vs_cpu=feat_err,
         probs_f32_card_vs_cpu=prob_err, pred_f32_card_vs_cpu_of_max=pred_err, limit=TEXT_LIMIT,
         min_cos_bf16_vs_f32=float(cos.min()), cos_min=TEXT_COS_MIN)
    check(feat_err <= TEXT_LIMIT, f"text features: f32 card vs CPU {feat_err}")
    check(prob_err <= TEXT_LIMIT, f"classify probabilities: f32 card vs CPU {prob_err}")
    check(pred_err <= TEXT_LIMIT, f"predictor: f32 card vs CPU {pred_err} of its max")
    check(float(cos.min()) >= TEXT_COS_MIN, f"bf16 text feature cosine {float(cos.min())}")


def gradio_module():
    """(gradio, what it is): the installed package, or a stand-in for the UI
    library alone (Interface, Image, Text) where gradio does not import."""
    import importlib
    import types

    try:
        gr = importlib.import_module("gradio")
        return gr, f"gradio {gr.__version__}"
    except ImportError:
        pass

    class Interface:
        def __init__(self, fn, inputs, outputs, title):
            self.fn, self.inputs, self.outputs, self.title = fn, inputs, outputs, title

    gr = types.ModuleType("gradio")
    gr.Interface = Interface
    gr.Image = lambda label: {"Image": label}
    gr.Text = lambda label: {"Text": label}
    return gr, "a stand-in (gradio does not import here)"


def run_gradio(restorer):
    """serve/gradio_app.build_app on the serve phase's full-width restorer
    (ViT-B-32 DaCLIP, nf 64 UNet, bf16, T = 100): one 256² request through
    the app's handler, with the exact launches of #1 (600) and #2 (300)."""
    from daclip_torch.serve import gradio_app

    gr, used = gradio_module()
    saved = sys.modules.get("gradio")
    sys.modules["gradio"] = gr
    try:
        app = gradio_app.build_app(restorer)
    finally:
        if saved is None:
            sys.modules.pop("gradio")
    handler = app.fn
    img = (np.random.RandomState(61).rand(256, 256, 3) * 255).round().astype(np.uint8)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, name = handler(img)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = {k: v for k, v in read_counts().items() if v}
    want_name = restorer.classify_degradation(img.astype(np.float32) / 255.0)[0]
    steps = restorer.sde.sample_T
    emit(phase="gradio", what="gradio_app.build_app's handler, one 256x256 uint8 request "
         "(classify, then restore at T=100)", gradio=used, latency_ms=ms, degradation=name,
         output_shape=list(out.shape), output_dtype=str(out.dtype), launches=counts)
    check(counts == {"wrap": 6 * steps, "flash": 3 * steps},
          f"gradio: launches {counts}, expected wrap {6 * steps}, flash {3 * steps}")
    check(name == want_name, f"gradio named {name}, classify_degradation {want_name}")
    check(out.shape == img.shape and out.dtype == np.uint8, f"gradio output {out.shape} "
          f"{out.dtype}")
    return {"wrap": counts["wrap"], "flash": counts["flash"]}


def run_shard_tiles(restorer, sds, smi):
    """A 1024² restore through the serve phase's full-width restorer
    (ViT-B-32 DaCLIP, nf 64 UNet, bf16, v5, T = 100; tile_size 512, overlap
    64, tile_batch 8: 3 × 3 tiles of 384²) unsharded, then twice through a
    shallow copy of it sharded over every card, or cuda:0 listed twice on
    one card. The first tile batch has the same tiles, noise and contexts in
    both: its first UNet call (the sampler's step T, split in chunks or
    whole) is held to ALT_FORWARD_FACTOR × the whole call's distance from
    an f32 UNet on the same inputs, as serve_alt holds a wiring; its tiles
    after the T steps, relative to their max, to that call's distance from
    f32 relative to its max (on seeded weights the samples grow to ~10³,
    and a rounding difference grows with them). The second batch's noise
    differs by its shape (8 against 1), as in daclip_tpu. The two sharded
    images must be equal bit for bit. Returns the first sharded restore's
    launches."""
    import copy

    from daclip_torch.models.unet import ConditionalUNet

    n_cards = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(n_cards)] if n_cards > 1 else ["cuda:0"] * 2
    sharded = copy.copy(restorer).shard_tiles(devices)
    cfg, steps = restorer.cfg, restorer.sde.sample_T
    side, seed = 1024, 7
    img = np.random.RandomState(seed).rand(side, side, 3).astype(np.float32)
    firsts = {}

    def recorded(r, key):
        """`r`'s sampler; its first run keeps, under `key`, its first UNet
        call's inputs and output and the run's tile outputs."""
        sample = r._sample

        def run(lq, generator, tctx, ictx, noise_fn=None):
            net, calls = noise_fn or r.unet, []

            def first_call(*a, **kw):
                out = net(*a, **kw)
                if not calls:
                    calls.append((a, kw, out))
                return out
            out = sample(lq, generator, tctx, ictx, noise_fn=first_call)
            firsts.setdefault(key, calls[:1] + [out])
            return out
        return run

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():  # cuDNN's choices at the three batch shapes, once
            for b in (cfg.tile_batch, 1, cfg.tile_batch // len(devices)):
                x = torch.rand(b, 3, 384, 384, device="cuda")
                c = torch.rand(b, cfg.context_dim, device="cuda")
                restorer.unet(x, x, torch.full((b,), 50.0, device="cuda"), c, c)
        runs, launches = {}, {}
        for key, r, chunks in (("unsharded", restorer, 1), ("sharded", sharded, len(devices)),
                               ("sharded_again", sharded, len(devices))):
            r._sample = recorded(r, key)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            try:
                runs[key] = out = r.restore(img, seed=seed, return_uint8=False)
            finally:
                del r._sample
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches[key] = {k: v for k, v in read_counts().items() if v}
            # two sampler runs (8 + 1 tiles, or 8 + 8), each UNet call in `chunks`
            want = {"wrap": 2 * steps * 6 * chunks, "flash": 2 * steps * 3 * chunks}
            emit(phase="shard_tiles", restore=key, devices=devices if chunks > 1 else
                 [str(restorer.device)], image=[side, side], tiles=9,
                 tile_batches=[8, 8] if chunks > 1 else [8, 1], steps=steps, seconds=seconds,
                 max_memory_allocated=torch.cuda.max_memory_allocated(),
                 launches=launches[key], finite=bool(np.isfinite(out).all()), card=smi)
            check(out.shape == (side, side, 3) and np.isfinite(out).all(),
                  f"shard_tiles {key}: output {out.shape} not finite or not {side}²")
            check(launches[key] == want, f"shard_tiles {key}: launches {launches[key]}, "
                  f"expected {want}")
        (args, kw, whole), first_plain = firsts["unsharded"]
        (_, _, split), first_sharded = firsts["sharded"]
        unet32 = ConditionalUNet(nf=cfg.nf, ch_mult=cfg.ch_mult, context_dim=cfg.context_dim,
                                 use_degra_context=True, use_image_context=True)
        unet32.load_state_dict(sds[0], strict=True)
        with torch.no_grad():
            floor = float((whole.float() - unet32.cuda().eval()(*args, **kw)).abs().max())
        del unet32
    finally:
        torch.backends.cudnn.deterministic = deterministic
    step_err = float((split.float() - whole.float()).abs().max())
    limit = ALT_FORWARD_FACTOR * floor
    whole_max = float(whole.float().abs().max())
    batch_err = float(np.abs(first_sharded - first_plain).max())
    batch_max = float(np.abs(first_plain).max())
    repeats = bool(np.array_equal(runs["sharded"], runs["sharded_again"]))
    emit(phase="shard_tiles", what="the first tile batch (8 tiles of 384²): its first UNet "
         "call split against whole, and its tiles after the T steps; the sharded image "
         "against a second sharded run", first_call_shape=list(whole.shape),
         first_call_max_abs_err=step_err, first_call_whole_vs_f32=floor,
         first_call_limit=limit, first_call_output_max=whole_max,
         first_batch_max_abs_err=batch_err, first_batch_output_max=batch_max,
         first_batch_err_of_max=batch_err / batch_max,
         first_batch_limit_of_max=floor / whole_max,
         image_max_abs_diff=float(np.abs(runs["sharded"] - runs["unsharded"]).max()),
         repeats_bitwise=repeats, card=smi)
    check(first_plain.shape == first_sharded.shape == (cfg.tile_batch, 384, 384, 3),
          f"shard_tiles: first batches {first_plain.shape}, {first_sharded.shape}")
    check(np.isfinite(first_sharded).all(), "shard_tiles: the first tile batch not finite")
    check(batch_err / batch_max <= floor / whole_max, f"shard_tiles: the first tile batch "
          f"differs by {batch_err / batch_max} of its max after the steps (limit "
          f"{floor / whole_max}: one call's distance from f32 of its max)")
    check(step_err <= limit, f"shard_tiles: the split first UNet call is {step_err} from the "
          f"whole one (limit {limit}: {ALT_FORWARD_FACTOR} × its {floor} from f32)")
    check(repeats, "shard_tiles: two sharded restores with one seed differ")
    return launches["sharded"]


def run_profile(restorer, forwards=5, wiring="v5"):
    """Where one sampler step's time goes: one ConditionalUNet forward at 256²,
    B=1, bf16 — host wall time unprofiled, then the device kernels that
    torch.profiler records, summed by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    x = torch.rand(1, 3, 256, 256, device="cuda")
    c = torch.rand(1, restorer.cfg.context_dim, device="cuda")
    t = torch.full((1,), 50.0, device="cuda")
    step = lambda: restorer.unet(x, x, t, c, c)
    with torch.no_grad():
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(forwards):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / forwards
        with profiled([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                      record_shapes=True) as prof:
            for _ in range(forwards):
                step()
            torch.cuda.synchronize()
    by_name, launches, ours = {}, 0, {}
    conv_us, conv_calls = 0.0, 0  # the 3×3 convs: aten::conv2d with a (O, C, 3, 3) weight
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            launches += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            if "daclip::" in e.name:  # the port's kernels by namespace (wrap, flash, …)
                ns = e.name.split("daclip::", 1)[1].split("::", 1)[0]
                ours[ns] = ours.get(ns, 0.0) + e.time_range.elapsed_us() / forwards / 1e3
        elif (e.name == "aten::conv2d" and len(e.input_shapes) > 1
              and list(e.input_shapes[1][-2:]) == [3, 3]):
            conv_calls += 1
            total = getattr(e, "device_time_total", None)  # cuda_time_total before torch 2.4
            conv_us += e.cuda_time_total if total is None else total
    kernel_ms = sum(by_name.values()) / forwards / 1e3
    conv_ms = conv_us / forwards / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit(phase="profile", wiring=wiring, what="one ConditionalUNet forward, 256x256, B=1, bf16",
         wall_ms_per_forward=wall_ms,
         device_kernel_ms_per_forward=kernel_ms if launches else None,
         device_busy_share=kernel_ms / wall_ms if launches else None,
         kernels_per_forward=launches / forwards,
         conv3x3_calls_per_forward=conv_calls / forwards,
         conv3x3_device_ms_per_forward=conv_ms if launches else None,
         conv3x3_share_of_device=conv_ms / kernel_ms if launches else None,
         daclip_ms_per_forward_by_namespace=ours,
         top=[dict(name=k[:90], ms_per_forward=v / forwards / 1e3) for k, v in top])


# -- phase 6 -------------------------------------------------------------------
def rel_err(got, want):
    """max |got − want| over max |want|, in f32."""
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-30))


def wrap_grads(grads):
    """The wrap's six gradients by name, dW_qkv split into its q, k, v blocks
    so that a wrong dk cannot hide behind a large dq."""
    dx, dg_pre, dw_qkv, dw_out, db_out, dg_out = grads
    return dict(dx=dx, dg_pre=dg_pre, dw_q=dw_qkv[:, :128], dw_k=dw_qkv[:, 128:256],
                dw_v=dw_qkv[:, 256:], dw_out=dw_out, db_out=db_out, dg_out=dg_out)


def wgrad_yardstick(la, B, n, C, dtype, gen):
    """The weight-gradient launch alone at a wrap site, dW_qkv = xnᵀ·dqkv over
    the B·n rows (the larger of its two products), beside its one-call
    yardstick torch.matmul(xn.T, dqkv) on the same inputs (timed here only;
    device ms by `device_ms`)."""
    from daclip_torch.ops import _build

    xn = torch.randn(B * n, C, generator=gen, device="cuda").to(dtype)
    dqkv = torch.randn(B * n, 3 * la.HID, generator=gen, device="cuda").to(dtype)
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    kernel = lambda: la._wgrad(lib, xn, dqkv, stream)
    library = lambda: torch.matmul(xn.t(), dqkv)
    got = kernel()
    want = torch.matmul(xn.float().t(), dqkv.float())  # f32, TF32 off
    err = rel_err(got, want)
    del want
    check(err <= WGRAD_LIMIT, f"wgrad {B * n, C, 3 * la.HID} rel err {err}")
    return dict(wgrad_rel_err=err,
                wgrad_ms=time_ms(kernel, iters=10),
                wgrad_device_ms=device_ms(kernel, "wgrad"),
                wgrad_library_ms=time_ms(library, iters=10),
                wgrad_library_device_ms=device_ms(library, ""))


def wrap_bwd_check(B, n, C, dtype, gen, balanced, phase="kernels_bwd", path=None, timed=True):
    """The wrap's forward as training calls it and its backward at one site
    against the plain versions (each twice, the bytes must repeat), timed
    with its weight-gradient launch once a shape when `timed`; its row."""
    from daclip_torch.ops import linear_attention as la

    args = wrap_case(B, n, C, dtype, gen, balanced)
    dout = torch.randn(B, n, C, generator=gen, device="cuda").to(dtype)
    out, stats = la._forward_kernel(*args, keep_stats=True)
    got = wrap_grads(la.attn_wrap_bwd(*args, dout, stats=stats))
    torch.cuda.synchronize()
    # both calls again: forward (output and kept statistics) and backward
    out2, stats2 = la._forward_kernel(*args, keep_stats=True)
    again = wrap_grads(la.attn_wrap_bwd(*args, dout, stats=stats2))
    fwd_repeats = torch.equal(out, out2) and all(
        torch.equal(a, b) for a, b in zip(stats, stats2))
    repeats = all(torch.equal(got[k], again[k]) for k in got)
    del out2, stats2, again
    fargs = [a.float() for a in args]
    want_out = la.attn_wrap_reference(*fargs)
    fwd_err = (out.float() - want_out).abs()
    share = attention_share(want_out, fargs[0], fargs[4], fargs[5])
    fwd = dict(max_abs_err=float(fwd_err.max()), mean_abs_err=float(fwd_err.mean()),
               limit=LIMITS[("wrap", dtype)], repeats_bitwise=fwd_repeats)
    del out, want_out, fwd_err
    want = wrap_grads(la.attn_wrap_bwd_reference(*fargs, dout.float()))
    errs = {k: rel_err(got[k], want[k]) for k in got}
    abs_err = max(float((got[k].float() - want[k]).abs().max()) for k in got)
    finite = all(bool(torch.isfinite(g).all()) for g in got.values())
    del want, fargs
    limit = BWD_LIMITS[("wrap", dtype)]
    row = dict(phase=phase, kernel="attn_wrap_bwd", shape=[B, n, C],
               dtype=str(dtype).split(".")[-1], balanced=balanced, forward=fwd,
               rel_err=errs, max_rel_err=max(errs.values()), max_abs_err=abs_err,
               limit=limit, repeats_bitwise=repeats, attention_share=share)
    if path:
        row["path"] = path
    if timed and not balanced:
        row.update(wgrad_yardstick(la, B, n, C, dtype, gen))
        esize = args[0].element_size()
        # the forward as training calls it (keeping its statistics), timed
        fms, fby = linattn_bound(B, n, C, esize, dtype)
        keep = lambda: la._forward_kernel(*args, keep_stats=True)
        fsplit = {}
        fwd.update(ms=time_ms(keep, iters=10),
                   device_ms=device_ms(keep, "daclip::wrap::", split=fsplit),
                   bound_ms=fms, bound_by=fby, split=fsplit)
        nbytes = (3 * B * n * C + 2 * (C * 384 + 128 * C + 3 * C)) * esize
        bms, by = bound_ms(nbytes, 2 * B * n * (1536 * C + 20480), dtype)
        split = {}
        row.update(kernel_ms=time_ms(lambda: la.attn_wrap_bwd(*args, dout, stats=stats),
                                     iters=10),
                   device_ms=device_ms(lambda: la.attn_wrap_bwd(*args, dout, stats=stats),
                                       "daclip::wrap_bwd::", iters=5, split=split),
                   plain_ms=time_ms(lambda: la.attn_wrap_bwd_reference(*args, dout),
                                    iters=5, warmup=1),
                   bound_ms=bms, bound_by=by, library_ms=None, split=split)
        if dtype == torch.bfloat16:
            row["resources"] = linattn_resources("bwd", C)
    emit(**row)
    what = f"wrap bwd {B, n, C, dtype}" + (" balanced" if balanced else "")
    check(fwd["max_abs_err"] <= fwd["limit"], f"{what}: forward max err {fwd}")
    check(fwd_repeats, f"{what}: two forward calls differ")
    check(repeats, f"{what}: two backward calls differ")
    if dtype == torch.bfloat16:
        check(fwd["mean_abs_err"] <= WRAP_MEAN_LIMIT_BF16, f"{what}: forward mean err {fwd}")
    check(finite, f"{what} not finite")
    check(row["max_rel_err"] <= limit, f"{what} rel err {errs}")
    if balanced:
        check(share >= SIGNAL_MIN, f"{what}: the attention's share {share} is too small")
    del got, args, dout, stats
    torch.cuda.empty_cache()
    return row


def flash_bwd_check(B, N, H, D, dtype, gen, phase="kernels_bwd", path=None):
    """The flash forward as training calls it and its backward at one shape
    against the plain versions (the backward twice, the bytes must repeat),
    with SDPA's backward beside it; its row."""
    from daclip_torch.ops import flash_attention as fa

    q, k, v, dout = [torch.randn(B, N, H * D, generator=gen, device="cuda").to(dtype)
                     for _ in range(4)]
    out, lse = fa._forward_kernel(q, k, v, H, D, True)
    bwd = lambda: fa.flash_self_attention_bwd(q, k, v, out, dout, H, D, lse=lse)
    got = dict(zip(("dq", "dk", "dv"), bwd()))
    torch.cuda.synchronize()
    repeats = all(torch.equal(a, b) for a, b in zip(got.values(), bwd()))
    want_out = fa.attention_reference(q.float(), k.float(), v.float(), H, D)
    fwd = dict(max_rel_err=rel_err(out, want_out),
               max_abs_err=float((out.float() - want_out).abs().max()),
               limit=LIMITS[("flash", dtype)])
    want = fa.attention_bwd_reference(q.float(), k.float(), v.float(), want_out,
                                      dout.float(), H, D)
    errs = {kk: rel_err(got[kk], w) for kk, w in zip(got, want)}
    abs_err = max(float((got[kk].float() - w).abs().max()) for kk, w in zip(got, want))
    del want, want_out
    limit = BWD_LIMITS[("flash", dtype)]
    heads = lambda t: t.view(B, N, H, D).transpose(1, 2)
    qh, kh, vh = (heads(t).detach().requires_grad_() for t in (q, k, v))
    oh = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh)
    doh = heads(dout)
    lib = lambda: torch.autograd.grad(oh, (qh, kh, vh), doh, retain_graph=True)
    bms, by = bound_ms(8 * B * N * H * D * q.element_size(), 10 * B * H * N * N * D, dtype)
    row = dict(phase=phase, kernel="flash_self_attention_bwd",
               shape=[B, N, H, D], dtype=str(dtype).split(".")[-1], forward=fwd,
               rel_err=errs, max_rel_err=max(errs.values()), max_abs_err=abs_err,
               limit=limit, repeats_bitwise=repeats,
               kernel_ms=time_ms(bwd, iters=10),
               device_ms=device_ms(bwd, "daclip::flash_bwd::"),
               plain_ms=time_ms(lambda: fa.attention_bwd_reference(
                   q, k, v, out, dout, H, D), iters=5, warmup=1),
               bound_ms=bms, bound_by=by, library_ms=time_ms(lib, iters=10),
               # its event time holds autograd's host time
               library_device_ms=device_ms(lib, ""))
    row.update(over_library=row["device_ms"] / row["library_device_ms"],
               exp_floor_ms=2 * B * H * N * N / EXP_PER_S * 1e3)
    if dtype == torch.bfloat16:
        row["resources"] = flash_resources("bwd", D)
    if path:
        row["path"] = path
    emit(**row)
    check(fwd["max_rel_err"] <= fwd["limit"],
          f"flash {B, N, H, D, dtype}: forward rel err {fwd}")
    check(all(bool(torch.isfinite(g).all()) for g in got.values()),
          f"flash bwd {B, N, H, D, dtype} not finite")
    check(row["max_rel_err"] <= limit, f"flash bwd {B, N, H, D, dtype} rel err {errs}")
    check(repeats, f"flash bwd {B, N, H, D, dtype}: two calls differ")
    del q, k, v, dout, out, lse, got, qh, kh, vh, oh, doh, bwd
    torch.cuda.empty_cache()
    return row


def run_kernels_bwd():
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {"wrap_bwd": [], "flash_bwd": []}
    for (B, n, C, dtype), balanced in [(s, b) for s in WRAP_BWD_SHAPES for b in (False, True)]:
        rows["wrap_bwd"].append(wrap_bwd_check(B, n, C, dtype, gen, balanced))
    for (B, n, C, dtype), balanced in [(s, b) for s in WRAP_WIDTH_SHAPES for b in (False, True)]:
        rows["wrap_bwd"].append(wrap_bwd_check(B, n, C, dtype, gen, balanced, path="width",
                                               timed=False))
    for B, N, H, D, dtype in FLASH_BWD_SHAPES:
        rows["flash_bwd"].append(flash_bwd_check(B, N, H, D, dtype, gen))
    return rows


# -- phase 7 -------------------------------------------------------------------
# the kernels each wiring's training step must launch
TRAIN_KERNELS = {"v5": ("wrap", "wrap_bwd", "flash", "flash_bwd"),
                 "v4_pointwise": ("fused_v4", "dual", "flash", "flash_bwd"),
                 "v3_pointwise": ("wrap_fused", "dual", "flash", "flash_bwd")}


def run_train_check(wiring="v5"):
    """A small UNet in f32 (TF32 off) whose level 0 runs the linear attention
    (in `wiring`) and whose level 1 and middle run SpatialTransformers: the
    loss and every gradient through the kernels against the plain versions,
    swapped into the UNet module here only; then 8 AdamW steps on one fixed
    draw."""
    from daclip_torch.models import unet as unet_mod
    from daclip_torch.models.unet import ConditionalUNet
    from daclip_torch.ops import flash_attention as fa
    from daclip_torch.ops import linear_attention as la
    from daclip_torch.ops import pointwise as pw
    from daclip_torch.sde import IRSDE
    from daclip_torch.train.restoration import (RestorationTrainConfig, init_state, loss_fn,
                                                make_train_step)

    kw = dict(nf=32, ch_mult=(1, 2), context_dim=64, use_degra_context=True,
              use_image_context=True, spatial_attn_min_level=1)
    net = ConditionalUNet(**kw, **ALT_CONFIGS.get(wiring, {}))
    net.load_state_dict(seeded_state_dict(lambda: ConditionalUNet(**kw), seed=5))
    net.train()
    sde = IRSDE(max_sigma=50, T=100)
    cfg = RestorationTrainConfig(niter=50, lr_G=1e-3, warmup_iter=5)
    gen = torch.Generator(device="cuda").manual_seed(6)
    gt = torch.rand(2, 3, 64, 64, generator=gen, device="cuda")
    lq = (gt + 0.1 * torch.randn(gt.shape, generator=gen, device="cuda")).clamp(0, 1)
    tctx, ictx = (torch.randn(2, 64, generator=gen, device="cuda") for _ in range(2))
    t, xt = sde.generate_random_states(gt, lq, torch.Generator(device="cuda").manual_seed(7))
    state = init_state(net, cfg, device="cuda")
    step = make_train_step(net, sde, cfg, device="cuda")

    def grads():
        net.zero_grad(set_to_none=True)
        loss = loss_fn(net, sde, cfg, xt, lq, gt, t, tctx, ictx)
        loss.backward()
        return loss.item(), {k: p.grad.clone() for k, p in net.named_parameters()
                             if p.grad is not None}

    reset_counts()
    loss_k, g_k = grads()
    calls = {k: read_counts()[k] for k in TRAIN_KERNELS[wiring]}
    plain = dict(attn_wrap=la.attn_wrap_reference, flash_self_attention=fa.attention_reference,
                 linear_attention_fused=la.fused_composition_reference,
                 attn_wrap_fused=la.attn_wrap_reference,
                 dual_conv1x1=pw.dual_conv1x1_reference)
    saved = {name: getattr(unet_mod, name) for name in plain}
    for name, fn in plain.items():
        setattr(unet_mod, name, fn)
    try:
        loss_p, g_p = grads()
    finally:
        for name, fn in saved.items():
            setattr(unet_mod, name, fn)
    check(set(g_k) == set(g_p), "kernel and plain runs give gradients to different tensors")
    errs = {k: rel_err(g_k[k], g_p[k]) for k in g_p if float(g_p[k].abs().max()) > 0}
    worst = max(errs, key=errs.get)

    losses = []
    for _ in range(8):  # the same (t, noise) draw each step
        state, m = step(state, dict(LQ=lq, GT=gt, text_context=tctx, image_context=ictx),
                        torch.Generator(device="cuda").manual_seed(7))
        losses.append(float(m["loss"]))
    row = dict(phase="train_check", wiring=wiring, unet=kw, loss_kernels=loss_k,
               loss_plain=loss_p, tensors=len(errs), worst_tensor=worst,
               worst_rel_err=errs[worst], limit=TRAIN_CHECK_LIMIT, calls=calls,
               adamw_losses=losses)
    emit(**row)
    check(all(c > 0 for c in calls.values()), f"train_check did not run every kernel: {calls}")
    check(abs(loss_k - loss_p) <= TRAIN_CHECK_LIMIT * abs(loss_p), "train_check loss differs")
    check(errs[worst] <= TRAIN_CHECK_LIMIT, f"train_check gradient of {worst}: {errs[worst]}")
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"8 AdamW steps did not lower the loss: {losses}")


# -- phase 8 -------------------------------------------------------------------
def run_train(steps=5, warmup=2, wiring="v5"):
    """The production training step at full width, as the JAX CLI composes it
    (cli/train_restoration.py:156-260): seeded UNet and DaCLIP weights,
    seeded 16 × 256² LQ/GT batches and their 224² CLIP views; the UNet in
    `wiring`. In the default wiring a checkpoint of the result restores."""
    import gc
    import tempfile

    from daclip_torch.convert import load_torch_state_dict
    from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config
    from daclip_torch.models.unet import ConditionalUNet
    from daclip_torch.pipeline import DACLIPRestorer, RestorerConfig
    from daclip_torch.sde import IRSDE
    from daclip_torch.train.restoration import (RestorationTrainConfig, init_state,
                                                make_train_step)
    from daclip_torch.transforms import clip_transform
    from daclip_torch.utils.checkpoint import save_checkpoint

    gc.collect()
    torch.cuda.empty_cache()
    B, P = 16, 256
    kw = dict(nf=64, ch_mult=(1, 2, 4, 8), context_dim=512, use_degra_context=True,
              use_image_context=True)
    unet = ConditionalUNet(dtype=torch.bfloat16, remat=P >= 256, **kw,
                           **ALT_CONFIGS.get(wiring, {}))
    unet.load_state_dict(seeded_state_dict(lambda: ConditionalUNet(**kw), seed=11))
    unet.train()
    clip_cfg = CLIPCfg.from_dict(get_model_config("daclip_ViT-B-32"))
    daclip_sd = seeded_state_dict(lambda: DaCLIP(clip_cfg), seed=12)
    daclip = DaCLIP(clip_cfg, dtype=torch.bfloat16)
    daclip.load_state_dict(daclip_sd, strict=True)
    daclip.cuda().eval().requires_grad_(False)
    sde = IRSDE(max_sigma=50, T=100, schedule="cosine", eps=0.005)
    cfg = RestorationTrainConfig()  # AdamW 2e-4, cosine, betas (0.9, 0.99), EMA 0.995/10
    state = init_state(unet, cfg, device="cuda")
    train_step = make_train_step(unet, sde, cfg, device="cuda")

    rng = np.random.RandomState(0)
    gt_np = rng.rand(B, P, P, 3).astype(np.float32)
    lq_np = np.clip(gt_np + 0.1 * rng.randn(B, P, P, 3), 0, 1).astype(np.float32)
    views_np = np.stack([clip_transform(im, clip_cfg.vision.image_size) for im in lq_np])
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).cuda()
    gt, lq, views = dev(gt_np), dev(lq_np), dev(views_np)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def full_step():
        with torch.no_grad():
            img_f, degra_f = daclip.encode_image(views, control=True, normalize=True)
        batch = dict(LQ=lq, GT=gt, text_context=degra_f.float(), image_context=img_f.float())
        return train_step(state, batch, gen)

    fwd = 2 if unet.remat else 1  # remat runs each checkpointed forward twice
    want_calls = dict(zip(TRAIN_KERNELS[wiring], {
        "v5": (6 * fwd, 6, 3 * fwd, 3),
        "v4_pointwise": (6 * fwd, 9 * fwd, 3 * fwd, 3)}[wiring]))
    for _ in range(warmup):
        full_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    records, totals = [], {}
    for i in range(steps):
        reset_counts()
        t0 = time.perf_counter()
        _, m = full_step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        calls = {k: v for k, v in read_counts().items() if v}
        for k, v in calls.items():
            totals[k] = totals.get(k, 0) + v
        rec = dict(step=state.step, ms=ms, loss=float(m["loss"]),
                   grad_norm=float(m["grad_norm"]), lr=m["lr"], calls=calls)
        records.append(rec)
        emit(phase="train_step", wiring=wiring, **rec)
        check(np.isfinite([rec["loss"], rec["grad_norm"]]).all(), f"step {i} not finite")
        check(calls == want_calls, f"step {i}: kernel calls {calls}, expected {want_calls} "
              f"with remat={unet.remat}")
    step_ms = float(np.median([r["ms"] for r in records]))
    row = dict(phase="train" if wiring == "v5" else "train_alt", wiring=wiring,
               config=dict(B=B, patch=P, remat=unet.remat, dtype="bfloat16",
                           optimizer=cfg.optimizer, lr=cfg.lr_G, **kw,
                           **ALT_CONFIGS.get(wiring, {})),
               unet_params=sum(p.numel() for p in unet.parameters()),
               ms_per_step=[r["ms"] for r in records], median_ms_per_step=step_ms,
               samples_per_s=B * 1e3 / step_ms,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               calls_per_step=want_calls, ema_step=state.ema.step)
    if wiring != "v5":
        emit(**row)
        return full_step, step_ms, totals

    with tempfile.TemporaryDirectory() as d:
        path = save_checkpoint(d, unet, state)
        restorer = DACLIPRestorer(RestorerConfig(), load_torch_state_dict(path), daclip_sd,
                                  device="cuda")
    out = restorer.restore(np.random.RandomState(1).rand(P, P, 3).astype(np.float32), seed=0,
                           return_uint8=False)
    row.update(restore_shape=list(out.shape), restore_finite=bool(np.isfinite(out).all()))
    emit(**row)
    check(row["restore_shape"] == [P, P, 3] and row["restore_finite"],
          "the saved EMA UNet did not restore a finite 256² image")
    del restorer
    return full_step, step_ms, totals


# -- phase 9 -------------------------------------------------------------------
def profile_one(step, wall_ms, n_top=15):
    """Where one call of `step` spends device time (torch.profiler): the
    device events' sum and its share of `wall_ms` (the unprofiled wall
    time), the event count, the port's kernels by namespace, the top
    names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    with profiled([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by_name, launches, ours = {}, 0, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            launches += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            if "daclip::" in e.name:  # the port's kernels by namespace (wrap, flash_bwd, …)
                ns = e.name.split("daclip::", 1)[1].split("::", 1)[0]
                ours[ns] = ours.get(ns, 0.0) + e.time_range.elapsed_us() / 1e3
    kernel_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]
    return dict(device_kernel_ms=kernel_ms if launches else None,
                device_busy_share=kernel_ms / wall_ms if launches else None,
                kernels=launches, daclip_ms_by_namespace=ours,
                top=[dict(name=k[:90], ms=v / 1e3) for k, v in top])


def run_profile_train(full_step, step_ms, wiring="v5"):
    """Where one full-width training step's device time goes (torch.profiler)."""
    p = profile_one(full_step, step_ms)
    emit(phase="profile_train", wiring=wiring,
         what="one training step, B=16, 256x256, bf16, remat",
         wall_ms_per_step_unprofiled=step_ms,
         device_kernel_ms_per_step=p["device_kernel_ms"],
         device_busy_share=p["device_busy_share"], kernels_per_step=p["kernels"],
         daclip_ms_by_namespace=p["daclip_ms_by_namespace"], top=p["top"])


# -- phase 11 ------------------------------------------------------------------
CLI_MD_SHAPE = (288, 320)      # (H, W) of the MD tree's images: H != W, both past the patch
CLI_VAL_SHAPE = (256, 272)
CLI_TEST_SHAPE = (256, 256)
# depth cut from 12 steps and a resume to 16 (validation every 6), then to 2 and a
# resume to 4 when the wild_ir phases came, then to 1 and a resume to 2 (validation
# every step) once a slower host took the script to 1103 s, to keep the script well
# inside its time limit: the steps wait on the host's PNG decode (~37 s a step)
CLI_STEPS, CLI_RESUME_STEPS, CLI_VAL_FREQ, CLI_VAL_T = 1, 2, 1, 10
# a separate fresh run for the loop's pace: steps start to start, no validation or
# checkpoint inside it (the runs above take one step each)
CLI_PACE_STEPS = 8


def write_md_tree(root, types, pairs, shape, seed, filters=("up", "paeth")):
    """`root/<type>/{GT,LQ}/<i>.png`: seeded GT and GT + noise as LQ, pair i
    written with the row filter filters[i % len(filters)] (the even pairs
    Up, the odd Paeth)."""
    from daclip_torch.data import png

    rng = np.random.RandomState(seed)
    for t in types:
        for sub in ("GT", "LQ"):
            (root / t / sub).mkdir(parents=True)
        for i in range(pairs):
            gt = rng.rand(*shape, 3)
            lq = np.clip(gt + 0.1 * rng.randn(*shape, 3), 0, 1)
            for sub, img in (("GT", gt), ("LQ", lq)):
                png.write(str(root / t / sub / f"{i:03d}.png"),
                          (img * 255).round().astype(np.uint8), filters[i % len(filters)])


def png_decode_ms(shape=CLI_MD_SHAPE, repeats=3, seed=0):
    """Median host ms of `data/png.decode` on one seeded BGR image of `shape`
    encoded with each row filter."""
    from daclip_torch.data import png

    img = (np.random.RandomState(seed).rand(*shape, 3) * 255).astype(np.uint8)
    out = {}
    for filt in ("none", "sub", "up", "average", "paeth"):
        data = png.encode(img, filt)
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            dec = png.decode(data)
            times.append((time.perf_counter() - t0) * 1e3)
        check(np.array_equal(dec, img), f"PNG with {filt} rows does not decode to its image")
        out[filt] = float(np.median(times))
    return out


def loader_samples_per_s(dataset_opt, workers, batches=2):
    """Samples/s of the port's DataLoader over the dataset of `dataset_opt`
    (MD: decode, crop, flip/rot, CLIP view; MDGT: the same with
    `random_degrade` in place of the LQ read; no model): `batches` batches
    after the loader is built, threads started inside the timing."""
    from daclip_torch.data import DataLoader, IterSampler, create_dataset

    ds = create_dataset(dict(dataset_opt))
    loader = DataLoader(ds, batch_size=dataset_opt["batch_size"],
                        sampler=IterSampler(len(ds), ratio=200), num_workers=workers)
    t0 = time.perf_counter()
    n = 0
    for i, batch in enumerate(loader):
        n += len(batch["GT"])
        if i + 1 == batches:
            break
    return n / (time.perf_counter() - t0)


def step_timer(make_step, records):
    """`make_step` with each step it makes timed to a synchronize: a record
    of the state's step before it, its start and its ms is appended to
    `records`."""
    def timed_make_step(*args, **kw):
        step = make_step(*args, **kw)

        def timed(state, batch, generator):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            before = state.step
            out = step(state, batch, generator)
            torch.cuda.synchronize()
            records.append(dict(step=before, start=t0, ms=(time.perf_counter() - t0) * 1e3,
                                loss=float(out[1]["loss"])))
            return out

        return timed

    return timed_make_step


def validations(steps, resume_steps, val_freq):
    """Validations of a CLI run to `steps` and its resume to `resume_steps`:
    every val_freq-th step of each run, and one at each run's end."""
    return (steps // val_freq + 1
            + sum(1 for s in range(steps + 1, resume_steps + 1) if s % val_freq == 0) + 1)


def run_train_cli(train_step_ms, lpips_weights):
    """`python -m daclip_torch.cli.train_restoration -opt train.yml` in process
    on seeded PNG folders: configs/daclip-sde/train.yml at full width (B=16,
    256², nf 64, ch_mult 1,2,4,8, context 512, both contexts, AdamW, bf16)
    with a seeded ViT-B-32 DA-CLIP .pt; CLI_STEPS steps (validation and
    checkpoints every CLI_VAL_FREQ), a resume to CLI_RESUME_STEPS, then
    `cli.test_restoration --lpips-weights` over an LMDB at T=100. The step
    function is timed by a hook around the CLI's `make_step`. Returns the
    launches of the training runs and of the test run."""
    import gc
    import logging
    import tempfile

    import yaml

    from daclip_torch import config as cfg_mod
    from daclip_torch.cli import test_restoration as cli_test
    from daclip_torch.cli import train_restoration as cli_train
    from daclip_torch.data import native_io
    from daclip_torch.tools.create_lmdb import create_lmdb

    gc.collect()
    torch.cuda.empty_cache()
    types = CLI_TYPES
    records = []
    real_make_step = cli_train.make_step
    timed_make_step = step_timer(real_make_step, records)

    with tempfile.TemporaryDirectory() as d:
        root = pathlib.Path(d)
        t0 = time.perf_counter()
        train_tree, daclip_pt = cli_inputs()
        write_md_tree(root / "val", types, 1, CLI_VAL_SHAPE, seed=22)
        write_md_tree(root / "test_png", ["set"], 2, CLI_TEST_SHAPE, seed=23)
        for sub in ("GT", "LQ"):
            create_lmdb(str(root / "test_png" / "set" / sub), str(root / "lmdb" / sub),
                        verbose=False)
        opt = yaml.safe_load((REPO / "configs" / "daclip-sde" / "train.yml").read_text())
        opt["distortion"] = types       # the tree's two types
        opt["datasets"]["train"]["dataroot"] = str(train_tree)
        opt["datasets"]["val"]["dataroot"] = str(root / "val")
        opt["path"].update(root=str(root / "out"), daclip=str(daclip_pt))
        opt["train"].update(niter=CLI_STEPS, val_freq=CLI_VAL_FREQ)
        opt["logger"].update(print_freq=4, save_checkpoint_freq=CLI_VAL_FREQ)
        train_yml = root / "train.yml"
        train_yml.write_text(yaml.safe_dump(opt))
        test_opt = yaml.safe_load((REPO / "configs" / "daclip-sde" / "test.yml").read_text())
        test_opt["datasets"] = {"test1": dict(
            name="Test", mode="LQGT", data_type="lmdb",
            dataroot_GT=str(root / "lmdb" / "GT"), dataroot_LQ=str(root / "lmdb" / "LQ"))}
        test_opt["path"].update(root=str(root / "out"))
        test_yml = root / "test.yml"
        test_yml.write_text(yaml.safe_dump(test_opt))
        setup_s = time.perf_counter() - t0

        decode_ms = png_decode_ms()
        dataset_opt = cfg_mod.parse(str(train_yml))["datasets"]["train"]
        loader = {f"workers_{w}": loader_samples_per_s(dataset_opt, w, batches=1)
                  for w in (0, 8)}

        logging.getLogger("train").setLevel(logging.INFO)
        cli_train.make_step = timed_make_step
        reset_counts()
        native_io.calls.update(decode=0, unfilter=0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            first = cli_train.main(["-opt", str(train_yml), "--val-sample-T", str(CLI_VAL_T),
                                    "--device", "cuda"])
            n_first = len(records)
            second = cli_train.main(["-opt", str(train_yml), "--max-steps",
                                     str(CLI_RESUME_STEPS), "--val-sample-T", str(CLI_VAL_T),
                                     "--device", "cuda"])
        finally:
            cli_train.make_step = real_make_step
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        calls = {k: v for k, v in read_counts().items() if v}
        native_calls = dict(native_io.calls)
        peak = torch.cuda.max_memory_allocated()
        ckpt_dir = root / "out" / "experiments" / opt["name"] / "training_state"
        ckpts = sorted(os.listdir(ckpt_dir))

        pace_records = []
        pace_opt = dict(opt, path=dict(opt["path"], root=str(root / "pace")),
                        train=dict(opt["train"], niter=CLI_PACE_STEPS, val_freq=0),
                        logger=dict(opt["logger"], save_checkpoint_freq=0))
        pace_yml = root / "pace.yml"
        pace_yml.write_text(yaml.safe_dump(pace_opt))
        cli_train.make_step = step_timer(real_make_step, pace_records)
        t0 = time.perf_counter()
        try:
            cli_train.main(["-opt", str(pace_yml), "--val-sample-T", str(CLI_VAL_T),
                            "--device", "cuda"])
        finally:
            cli_train.make_step = real_make_step
        pace_s = time.perf_counter() - t0

        reset_counts()
        t0 = time.perf_counter()
        summary = cli_test.main(["-opt", str(test_yml), "--checkpoint", str(ckpt_dir),
                                 "--daclip", str(daclip_pt), "--lpips-weights", lpips_weights,
                                 "--device", "cuda"])["test1"]
        test_s = time.perf_counter() - t0
        test_calls = {k: v for k, v in read_counts().items() if v}

    n_val = validations(CLI_STEPS, CLI_RESUME_STEPS, CLI_VAL_FREQ)
    val_steps = n_val * len(types) * CLI_VAL_T     # two val images, CLI_VAL_T sampler steps
    n_steps = CLI_RESUME_STEPS
    want = {"wrap": 12 * n_steps + 6 * val_steps, "flash": 6 * n_steps + 3 * val_steps,
            "wrap_bwd": 6 * n_steps, "flash_bwd": 3 * n_steps}
    test_steps = 2 * 100
    want_test = {"wrap": 6 * test_steps, "flash": 3 * test_steps}
    step_ms = [r["ms"] for r in records]
    # host time from one step's start to the next's within a run: the step,
    # the wait for the loader and, after every CLI_VAL_FREQ-th step, validation
    # and a save
    gaps = [(b["start"] - a["start"]) * 1e3 for a, b in zip(records, records[1:])
            if b["step"] == a["step"] + 1 and b["step"] != CLI_STEPS]
    gap_ms = float(np.median(gaps)) if gaps else None   # none at one step a run
    # the pace run's step starts; the first gap holds the first step's warm-up
    pace_gaps = [(b["start"] - a["start"]) * 1e3 for a, b in zip(pace_records, pace_records[1:])]
    pace_ms = float(np.median(pace_gaps[1:]))
    pace_range = [float(min(pace_gaps[1:])), float(max(pace_gaps[1:]))]
    B = opt["datasets"]["train"]["batch_size"]
    row = dict(phase="train_cli", what=f"cli.train_restoration -opt train.yml ({CLI_STEPS} steps, "
               f"resume to {CLI_RESUME_STEPS}), then cli.test_restoration over an LMDB at "
               "T=100",
               config=dict(B=B, patch=opt["datasets"]["train"]["patch_size"],
                           n_workers=opt["datasets"]["train"]["n_workers"],
                           distortion=types, md_images=f"{len(types)}x8 pairs "
                           f"{CLI_MD_SHAPE[0]}x{CLI_MD_SHAPE[1]} (half Up, half Paeth)",
                           val_images=f"2 at {CLI_VAL_SHAPE[0]}x{CLI_VAL_SHAPE[1]}",
                           val_sample_T=CLI_VAL_T, unet=opt["network_G"]["setting"]),
               setup_s=setup_s, train_s=train_s, test_s=test_s,
               first=first, second=second, steps_run=[r["step"] for r in records],
               checkpoints=ckpts, ms_per_step=step_ms,
               median_ms_per_step=float(np.median(step_ms)),
               samples_per_s=B * 1e3 / float(np.median(step_ms)),
               median_ms_step_to_step=gap_ms,
               samples_per_s_step_to_step=gap_ms and B * 1e3 / gap_ms,
               pace=dict(steps=CLI_PACE_STEPS, seconds=pace_s,
                         ms_per_step=[r["ms"] for r in pace_records],
                         ms_step_to_step=pace_gaps,
                         median_ms_step_to_step_after_the_first=pace_ms,
                         range_ms_step_to_step_after_the_first=pace_range,
                         samples_per_s_step_to_step=B * 1e3 / pace_ms),
               native_io_calls=native_calls,
               train_phase_median_ms_per_step=train_step_ms,
               over_train_phase=float(np.median(step_ms)) / train_step_ms,
               loader_samples_per_s=loader, png_decode_ms_320x288=decode_ms,
               validations=n_val, launches=calls, want_launches=want,
               max_memory_allocated=peak,
               test=dict(images=len(summary["psnr"]), psnr=summary["psnr"],
                         ssim=summary["ssim"], psnr_y=summary["psnr_y"],
                         ssim_y=summary["ssim_y"], lpips=summary["lpips"],
                         ms_per_image=float(np.mean(summary["time"])) * 1e3,
                         launches=test_calls))
    emit(**row)
    check(all(np.isfinite([r["best_psnr"]]).all() for r in (first, second)),
          "train_cli: a validation PSNR is not finite")
    check(first["final_step"] == CLI_STEPS and second["final_step"] == CLI_RESUME_STEPS,
          f"train_cli ended at {first['final_step']} and {second['final_step']}")
    check(records[0]["step"] == 0 and records[n_first]["step"] == CLI_STEPS,
          f"train_cli: the resumed run started at {records[n_first]['step']}, not {CLI_STEPS}")
    check(len(records) == CLI_RESUME_STEPS, f"train_cli ran {len(records)} steps")
    want_ckpts = {f"{s}.pt" for s in (CLI_VAL_FREQ, CLI_STEPS, CLI_RESUME_STEPS)}
    check(want_ckpts <= set(ckpts), f"train_cli checkpoints: {ckpts}")
    check(calls == want, f"train_cli: kernel calls {calls}, expected {want}")
    check(native_calls["decode"] > 0, f"train_cli: the native decoder read no image "
          f"({native_calls})")
    check(len(pace_records) == CLI_PACE_STEPS and pace_records[0]["step"] == 0,
          f"train_cli's pace run ran steps {[r['step'] for r in pace_records]}")
    check(len(summary["psnr"]) == 2 and all(np.isfinite(v).all() for v in summary.values()),
          "test_restoration: metrics not finite")
    check(len(summary["lpips"]) == 2, f"test_restoration: LPIPS {summary['lpips']}")
    check(test_calls == want_test, f"test_restoration: kernel calls {test_calls}, "
          f"expected {want_test}")
    return {k: calls[k] for k in ("wrap", "flash", "wrap_bwd", "flash_bwd")}, test_calls


# -- phase 11b -----------------------------------------------------------------
# Wild-IR (configs/wild-ir/{train,test}.yml): ViT-L-14 DA-CLIP image contexts
# (768-d), no degradation context, the UNet's internal scale 0.5
WILD_DACLIP = "daclip_ViT-L-14"   # vision 1024 × 24, patch 14, 224² (257 positions)
WILD_KW = dict(nf=64, ch_mult=(1, 2, 4, 8), context_dim=768, use_degra_context=False,
               use_image_context=True, scale=0.5)
# at 256² the scale-0.5 UNet's levels run at 128², 64², 32² and 16²: the wrap's
# (n, C) at its six sites (down0 and up0 share one), flash's (N, heads,
# dim_head) at down3 and at mid and up3
WILD_WRAP_SITES = [(16384, 64), (4096, 64), (4096, 128), (1024, 128), (1024, 256)]
WILD_FLASH_SITES = [(256, 8, 32), (256, 16, 32)]
WILD_F32_B = 2            # the f32 step's batch: the CPU's side of the check sets it
WILD_F32_LIMIT = 1e-4     # f32 card vs f32 CPU, of the max: encode, forward, loss, params
WILD_UPDATE_LIMIT = 1e-2  # the f32 step's update p_after − p_before, of its max
WILD_GT = (16, (320, 384))  # GT PNGs (count, (H, W)), Up rows
# cut from wild-ir's 500k steps (val and checkpoints every 1e4): 3 steps with
# validation and a checkpoint at 2, then a resume to 4
WILD_STEPS, WILD_RESUME_STEPS, WILD_VAL_FREQ, WILD_VAL_T = 3, 4, 2, 10
WILD_TEST_T = 100


def cpu_copy(sd):
    """`sd` on the CPU, tensors shared by two names (DaCLIP's visual alias)
    still shared."""
    by_id = {}
    for v in sd.values():
        if id(v) not in by_id:
            by_id[id(v)] = v.cpu()
    return {k: by_id[id(v)] for k, v in sd.items()}


def wild_daclip(sd, device):
    """The f32 ViT-L-14 DaCLIP holding `sd`'s tensors on `device`, built on
    the meta device (not initialised: 0.76 B parameters), in eval mode."""
    from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config

    with torch.device("meta"):
        daclip = DaCLIP(CLIPCfg.from_dict(get_model_config(WILD_DACLIP)))
    daclip.load_state_dict({k: v.to(device) for k, v in sd.items()}, strict=True, assign=True)
    return daclip.eval().requires_grad_(False)


def wild_sites(unet, x, t, ictx):
    """The (B, n, C) of each wrap call and the (B, N, heads, dim_head) of
    each flash call in one forward of `unet` (the UNet module's kernel
    entry points swapped for recorders here only)."""
    from daclip_torch.models import unet as unet_mod

    seen = {"wrap": [], "flash": []}
    real_wrap, real_flash = unet_mod.attn_wrap, unet_mod.flash_self_attention

    def wrap(x, *a, **kw):
        seen["wrap"].append(tuple(x.shape))
        return real_wrap(x, *a, **kw)

    def flash(q, k, v, heads, dim_head):
        seen["flash"].append((q.shape[0], q.shape[1], heads, dim_head))
        return real_flash(q, k, v, heads, dim_head)

    unet_mod.attn_wrap, unet_mod.flash_self_attention = wrap, flash
    try:
        with torch.no_grad():
            unet(x, x, t, None, ictx)
    finally:
        unet_mod.attn_wrap, unet_mod.flash_self_attention = real_wrap, real_flash
    return seen


def wild_f32_step(device, unet_sd, daclip_sd, views, gt, lq, t, xt):
    """One f32 wild-ir training step (TF32 off) on `device` from the seeded
    weights: the f32 DaCLIP's image contexts of `views`, then the step on
    the given (t, x_t) draw at lr 1e-3 and Adam eps 1e-3 (as daclip_f32_step:
    a gradient that is 0 up to rounding then moves its parameter by ~0, not
    by ±lr). Returns (loss, parameters after)."""
    from daclip_torch.models.unet import ConditionalUNet
    from daclip_torch.sde import IRSDE
    from daclip_torch.train.restoration import (RestorationTrainConfig, init_state,
                                                make_train_step)

    with torch.no_grad():
        ictx = wild_daclip(daclip_sd, device).encode_image(views.to(device), control=True,
                                                           normalize=True)[0].float()
    unet = ConditionalUNet(**WILD_KW)
    unet.load_state_dict({k: v.to(device) for k, v in unet_sd.items()}, strict=True)
    unet.train()
    cfg = RestorationTrainConfig(lr_G=1e-3)
    state = init_state(unet, cfg, device=device)
    for group in state.optimizer.param_groups:
        group["eps"] = 1e-3
    sde = IRSDE(max_sigma=50, T=100, schedule="cosine", eps=0.005)
    sde.generate_random_states = lambda gt_, lq_, gen: (t.to(device), xt.to(device))
    _, m = make_train_step(unet, sde, cfg, device=device)(
        state, dict(LQ=lq.to(device), GT=gt.to(device), image_context=ictx))
    return float(m["loss"]), {n: p.detach().float().cpu() for n, p in unet.named_parameters()}


def run_wild_ir_models(unet_sd, daclip_sd):
    """Kernels #1-#4 at the shapes the scale-0.5 UNet gives them (read off a
    forward at B = 1 and 16), then the f32 ViT-L-14 DaCLIP, UNet forward and
    training step on the card against the CPU. Returns the kernel rows."""
    import gc

    from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config
    from daclip_torch.models.unet import ConditionalUNet
    from daclip_torch.sde import IRSDE
    from daclip_torch.transforms import clip_transform

    gen = torch.Generator(device="cuda").manual_seed(83)
    unet = ConditionalUNet(dtype=torch.bfloat16, **WILD_KW)
    unet.load_state_dict(unet_sd, strict=True)
    unet.cuda().eval()
    sites = {}
    for B in (1, 16):
        x = torch.rand(B, 3, 256, 256, generator=gen, device="cuda")
        ictx = torch.randn(B, 768, generator=gen, device="cuda")
        sites[B] = wild_sites(unet, x, torch.full((B,), 50.0, device="cuda"), ictx)
    del unet
    emit(phase="wild_ir_kernels", what="the kernels' shapes in one forward of the scale-0.5 "
         "UNet at 256²", sites={str(B): v for B, v in sites.items()})
    want_wrap = sorted(WILD_WRAP_SITES + WILD_WRAP_SITES[:1])
    want_flash = sorted(WILD_FLASH_SITES + WILD_FLASH_SITES[1:])
    for B, seen in sites.items():
        check(sorted(s[1:] for s in seen["wrap"]) == want_wrap
              and all(s[0] == B for s in seen["wrap"]),
              f"wild-ir wrap sites at B={B}: {seen['wrap']}")
        check(sorted(s[1:] for s in seen["flash"]) == want_flash
              and all(s[0] == B for s in seen["flash"]),
              f"wild-ir flash sites at B={B}: {seen['flash']}")

    rows = {"wrap": [], "flash": [], "wrap_bwd": [], "flash_bwd": []}
    bf16 = torch.bfloat16
    for B in (1, 16):
        path = "wild_ir_train" if B == 16 else "wild_ir_test"
        for (n, C), balanced in [(s, b) for s in WILD_WRAP_SITES for b in (False, True)]:
            rows["wrap"].append(wrap_check(B, n, C, bf16, gen, balanced, "wild_ir_kernels",
                                           path))
        for N, H, D in WILD_FLASH_SITES:
            rows["flash"].append(flash_check(B, N, H, D, bf16, B == 16, gen,
                                             "wild_ir_kernels", path))
    for (n, C), balanced in [(s, b) for s in WILD_WRAP_SITES for b in (False, True)]:
        rows["wrap_bwd"].append(wrap_bwd_check(16, n, C, bf16, gen, balanced,
                                               "wild_ir_kernels", "wild_ir_train"))
    for N, H, D in WILD_FLASH_SITES:
        rows["flash_bwd"].append(flash_bwd_check(16, N, H, D, bf16, gen, "wild_ir_kernels",
                                                 "wild_ir_train"))
    gc.collect()
    torch.cuda.empty_cache()

    # the frozen bf16 tower's contexts of a training batch, as the CLI's step
    # computes them
    with torch.device("cuda"):
        daclip = DaCLIP(CLIPCfg.from_dict(get_model_config(WILD_DACLIP)), dtype=torch.bfloat16)
    daclip.load_state_dict(daclip_sd, strict=True)
    daclip.eval().requires_grad_(False)
    views16 = torch.randn(16, 3, 224, 224, generator=gen, device="cuda")
    with torch.no_grad():
        encode_ms = time_ms(lambda: daclip.encode_image(views16, control=True, normalize=True),
                            iters=10)
    emit(phase="wild_ir_kernels", what=f"{WILD_DACLIP} encode_image(control=True) at B=16, "
         "bf16 (median of 10 CUDA-event timed calls)", encode_ms=encode_ms)
    del daclip, views16
    gc.collect()
    torch.cuda.empty_cache()

    # f32 on the card against the CPU, on the same numpy inputs
    t0 = time.perf_counter()
    rng = np.random.RandomState(84)
    gt_np = rng.rand(WILD_F32_B, 256, 256, 3).astype(np.float32)
    lq_np = np.clip(gt_np + 0.1 * rng.randn(*gt_np.shape), 0, 1).astype(np.float32)
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    gt, lq = nchw(gt_np), nchw(lq_np)
    views = nchw(np.stack([clip_transform(im, 224) for im in lq_np]))
    cpu_sd = cpu_copy(daclip_sd)
    feats, outs = {}, {}
    for device in ("cuda", "cpu"):
        daclip = wild_daclip(daclip_sd if device == "cuda" else cpu_sd, device)
        with torch.no_grad():
            feats[device] = [f.cpu() for f in daclip.encode_image(views.to(device),
                                                                  control=True)]
        del daclip
        unet = ConditionalUNet(**WILD_KW)
        unet.load_state_dict({k: v.to(device) for k, v in unet_sd.items()}, strict=True)
        unet.to(device).eval()
        with torch.no_grad():
            outs[device] = unet(lq[:1].to(device), lq[:1].to(device),
                                torch.full((1,), 50.0, device=device), None,
                                feats["cuda"][0][:1].to(device)).cpu()
        del unet
    encode_err = max(rel_err(c, w) for c, w in zip(feats["cuda"], feats["cpu"]))
    forward_err = rel_err(outs["cuda"], outs["cpu"])
    sde = IRSDE(max_sigma=50, T=100, schedule="cosine", eps=0.005)
    t, xt = sde.generate_random_states(gt, lq, torch.Generator().manual_seed(85))
    step = {d: wild_f32_step(d, unet_sd, daclip_sd if d == "cuda" else cpu_sd, views, gt, lq,
                             t, xt) for d in ("cuda", "cpu")}
    del cpu_sd
    card, cpu = step["cuda"][1], step["cpu"][1]
    before = {k: v.float().cpu() for k, v in unet_sd.items()}
    u_err = {n: float(((card[n] - before[n]) - (p - before[n])).abs().max())
             for n, p in cpu.items()}
    u_max = max(float((p - before[n]).abs().max()) for n, p in cpu.items())
    p_err = max(float((card[n] - p).abs().max()) for n, p in cpu.items())
    p_max = max(float(p.abs().max()) for p in cpu.values())
    worst = max(u_err, key=u_err.get)
    f32 = dict(encode_image_control_err_of_max=encode_err, unet_forward_err_of_max=forward_err,
               loss_card=step["cuda"][0], loss_cpu=step["cpu"][0],
               loss_rel_err=abs(step["cuda"][0] - step["cpu"][0]) / abs(step["cpu"][0]),
               params_err_of_max=p_err / p_max, update_max=u_max,
               update_err_of_max=u_err[worst] / u_max, update_worst=worst)
    emit(phase="wild_ir_f32", what=f"f32 (TF32 off), card vs CPU: {WILD_DACLIP} "
         f"encode_image(control=True) at B={WILD_F32_B}, the scale-0.5 UNet forward at 256² "
         f"(B=1), one training step at B={WILD_F32_B}, 256², lr 1e-3, eps 1e-3",
         seconds=time.perf_counter() - t0, limit=WILD_F32_LIMIT,
         update_limit=WILD_UPDATE_LIMIT, **f32)
    for key in ("encode_image_control_err_of_max", "unet_forward_err_of_max", "loss_rel_err",
                "params_err_of_max"):
        check(f32[key] <= WILD_F32_LIMIT, f"wild_ir f32 {key}: {f32[key]}")
    check(f32["update_err_of_max"] <= WILD_UPDATE_LIMIT,
          f"wild_ir f32 update: {f32['update_err_of_max']} of its max ({worst})")
    return rows


def write_gt_tree(root, count, shape, seed):
    """`root/<i>.png`: seeded images with Up rows (a Paeth decode would hide
    the synthesis cost the wild-ir phase measures)."""
    from daclip_torch.data import png

    rng = np.random.RandomState(seed)
    root.mkdir(parents=True)
    for i in range(count):
        png.write(str(root / f"{i:03d}.png"),
                  (rng.rand(*shape, 3) * 255).round().astype(np.uint8), "up")


def write_pair_tree(root, shapes, seed):
    """`root/{GT,LQ}/<i>.png`: a seeded GT of each (H, W) in `shapes` and GT
    + noise as its LQ, Up rows."""
    from daclip_torch.data import png

    rng = np.random.RandomState(seed)
    for sub in ("GT", "LQ"):
        (root / sub).mkdir(parents=True)
    for i, shape in enumerate(shapes):
        gt = rng.rand(*shape, 3)
        lq = np.clip(gt + 0.1 * rng.randn(*shape, 3), 0, 1)
        for sub, img in (("GT", gt), ("LQ", lq)):
            png.write(str(root / sub / f"{i}.png"), (img * 255).round().astype(np.uint8))


def synthesis_ms(draws=32, seed=86):
    """Host ms of `random_degrade` on a 256² patch and of the CLIP view of
    its output, over `draws` seeded draws: [median, lower quartile, upper
    quartile] of each."""
    import random
    import warnings

    from daclip_torch.data.degradations import random_degrade
    from daclip_torch.transforms import clip_transform

    img = np.random.RandomState(seed).rand(256, 256, 3).astype(np.float32)
    deg, view = [], []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # under_display_filter's missing ucdpsf.pkl
        for i in range(draws):
            t0 = time.perf_counter()
            lq = random_degrade(img, rng=random.Random(seed + i))
            t1 = time.perf_counter()
            clip_transform(lq[:, :, ::-1].copy(), 224)
            t2 = time.perf_counter()
            deg.append((t1 - t0) * 1e3)
            view.append((t2 - t1) * 1e3)
    q = lambda a: [float(np.median(a)), *map(float, np.percentile(a, [25, 75]))]
    return dict(random_degrade_ms=q(deg), clip_view_ms=q(view))


def run_wild_ir():
    """The Wild-IR configuration through the port's entry points at full
    width: the kernels at its shapes and the f32 card-vs-CPU checks, then
    `cli.train_restoration -opt` on configs/wild-ir/train.yml (B=16, 256²,
    MDGT over seeded GT PNGs, a seeded ViT-L-14 DA-CLIP .pt; 3 steps with
    validation and a checkpoint at 2, a resume to 4), `cli.test_restoration
    -opt` on configs/wild-ir/test.yml over a 256² and a 200 × 300 pair at
    T=100 with the saved EMA UNet, `cli.predict --wild-ir` on one PNG, and
    `tools.generate_lq` / `generate_masked`. Returns the kernel rows and the
    launches of the train, test and predict paths."""
    import contextlib
    import gc
    import io
    import json as json_mod
    import logging

    import cv2
    import yaml

    from daclip_torch import config as cfg_mod
    from daclip_torch.cli import predict as cli_predict
    from daclip_torch.cli import test_restoration as cli_test
    from daclip_torch.cli import train_restoration as cli_train
    from daclip_torch.data import png
    from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config
    from daclip_torch.models.unet import ConditionalUNet
    from daclip_torch.tools.generate_lq import generate_LQ
    from daclip_torch.tools.generate_masked import generate_masked

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    clip_cfg = CLIPCfg.from_dict(get_model_config(WILD_DACLIP))
    daclip_sd = seeded_state_dict(lambda: DaCLIP(clip_cfg), seed=81)
    unet_sd = seeded_state_dict(lambda: ConditionalUNet(**WILD_KW), seed=82)
    daclip_params = sum(v.numel() for v in {id(v): v for v in daclip_sd.values()}.values())
    positions = tuple(daclip_sd["visual.positional_embedding"].shape)
    emit(phase="wild_ir", what="seeded weights", seconds=time.perf_counter() - t0,
         daclip=WILD_DACLIP, daclip_params=daclip_params, visual_positions=positions,
         unet=WILD_KW, unet_params=sum(v.numel() for v in unet_sd.values()))
    check(positions == (257, 1024), f"ViT-L-14 positional embedding {positions}")
    rows = run_wild_ir_models(unet_sd, daclip_sd)
    del unet_sd

    records, loaded = [], []
    real_make_step, real_load = cli_train.make_step, cli_train.load_daclip
    probe = torch.randn(2, 3, 224, 224, generator=torch.Generator("cuda").manual_seed(87),
                        device="cuda")

    def spy_load(opt, device):
        fn = real_load(opt, device)
        loaded.append((fn, fn(probe)))   # the contexts of a probe before any step
        return fn

    with tempfile.TemporaryDirectory() as d:
        root = pathlib.Path(d)
        t0 = time.perf_counter()
        write_gt_tree(root / "gt", *WILD_GT, seed=88)
        write_pair_tree(root / "val", [(256, 256)] * 2, seed=89)
        test_root = root / "test"
        write_pair_tree(test_root, [(256, 256), (200, 300)], seed=90)
        daclip_pt = root / "wild-daclip_ViT-L-14.pt"
        torch.save(cpu_copy(daclip_sd), daclip_pt)
        pt_bytes = daclip_pt.stat().st_size
        del daclip_sd
        gc.collect()
        torch.cuda.empty_cache()
        opt = yaml.safe_load((REPO / "configs" / "wild-ir" / "train.yml").read_text())
        opt["datasets"]["train"]["dataroot_GT"] = str(root / "gt")
        opt["datasets"]["val"].update(dataroot_GT=str(root / "val" / "GT"),
                                      dataroot_LQ=str(root / "val" / "LQ"))
        opt["path"].update(root=str(root / "out"), daclip=str(daclip_pt))
        opt["train"].update(niter=WILD_STEPS, val_freq=WILD_VAL_FREQ)
        opt["logger"].update(print_freq=1, save_checkpoint_freq=WILD_VAL_FREQ)
        train_yml = root / "train.yml"
        train_yml.write_text(yaml.safe_dump(opt))
        test_opt = yaml.safe_load((REPO / "configs" / "wild-ir" / "test.yml").read_text())
        test_opt["datasets"]["test1"].update(dataroot_GT=str(test_root / "GT"),
                                             dataroot_LQ=str(test_root / "LQ"))
        test_opt["path"].update(root=str(root / "out"), daclip=str(daclip_pt))
        test_yml = root / "test.yml"
        test_yml.write_text(yaml.safe_dump(test_opt))
        setup_s = time.perf_counter() - t0

        synth = synthesis_ms()
        dataset_opt = cfg_mod.parse(str(train_yml))["datasets"]["train"]
        loader = {f"workers_{w}": loader_samples_per_s(dataset_opt, w, batches=1)
                  for w in (0, 8)}

        logging.getLogger("train").setLevel(logging.INFO)
        cli_train.make_step = step_timer(real_make_step, records)
        cli_train.load_daclip = spy_load
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            first = cli_train.main(["-opt", str(train_yml), "--val-sample-T", str(WILD_VAL_T),
                                    "--device", "cuda"])
            n_first = len(records)
            second = cli_train.main(["-opt", str(train_yml), "--max-steps",
                                     str(WILD_RESUME_STEPS), "--val-sample-T",
                                     str(WILD_VAL_T), "--device", "cuda"])
        finally:
            cli_train.make_step, cli_train.load_daclip = real_make_step, real_load
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        calls = {k: v for k, v in read_counts().items() if v}
        peak = torch.cuda.max_memory_allocated()
        frozen = all(torch.equal(a, b) for fn, before in loaded
                     for a, b in zip(fn(probe), before))
        n_loaded = len(loaded)
        del loaded
        ckpt_dir = root / "out" / "experiments" / opt["name"] / "training_state"
        ckpts = sorted(os.listdir(ckpt_dir))
        gc.collect()
        torch.cuda.empty_cache()

        reset_counts()
        t0 = time.perf_counter()
        summary = cli_test.main(["-opt", str(test_yml), "--checkpoint", str(ckpt_dir),
                                 "--daclip", str(daclip_pt), "--save-images",
                                 "--device", "cuda"])["test1"]
        test_s = time.perf_counter() - t0
        test_calls = {k: v for k, v in read_counts().items() if v}
        saved = sorted((root / "out" / "results" / test_opt["name"] / "test1").glob("*.png"))
        saved_shapes = [png.read(str(p)).shape for p in saved]
        saved_finite = all(np.isfinite(png.read(str(p))).all() for p in saved)
        gc.collect()
        torch.cuda.empty_cache()

        reset_counts()
        t0 = time.perf_counter()
        cli_predict.main(["-i", str(test_root / "LQ" / "0.png"), "-o", str(root / "pred"),
                          "--checkpoint", str(ckpt_dir), "--daclip", str(daclip_pt),
                          "--wild-ir", "--device", "cuda"])
        predict_s = time.perf_counter() - t0
        predict_calls = {k: v for k, v in read_counts().items() if v}
        restored = png.read(str(root / "pred" / "0.png"))
        gc.collect()
        torch.cuda.empty_cache()

        # the offline tools on the card's host (cv2 and scipy inside their calls)
        src = root / "src"
        write_gt_tree(src, 2, WILD_GT[1], seed=91)
        tools = {}
        with contextlib.redirect_stdout(io.StringIO()):  # a line a level
            for deg_type in ("blur", "noisy", "resize", "jpeg"):
                t0 = time.perf_counter()
                generate_LQ([str(src)], deg_type, None, str(root / "lq"), 1, "train",
                            (256, 256), 92)
                tools[deg_type] = time.perf_counter() - t0
            t0 = time.perf_counter()
            masked = generate_masked(str(src), str(root / "masked"), 100, 93)
            tools["masked"] = time.perf_counter() - t0
        outputs = sorted((root / "lq").rglob("*.png")) + sorted((root / "masked").rglob("*.png"))
        decoded = [cv2.imread(str(p)) for p in outputs]
        shapes = {None if im is None else im.shape for im in decoded}
        prompts = [json_mod.loads(p.read_text())
                   for p in sorted((root / "lq").rglob("degraded_prompts.json"))]
        level_dirs = sorted(p.name for p in (root / "lq" / "train").iterdir())

    n_val = validations(WILD_STEPS, WILD_RESUME_STEPS, WILD_VAL_FREQ)
    val_steps = n_val * 2 * WILD_VAL_T       # two val images, WILD_VAL_T sampler steps
    n_steps = WILD_RESUME_STEPS
    # remat runs each checkpointed forward twice in a step
    want = {"wrap": 12 * n_steps + 6 * val_steps, "flash": 6 * n_steps + 3 * val_steps,
            "wrap_bwd": 6 * n_steps, "flash_bwd": 3 * n_steps}
    want_test = {"wrap": 6 * 2 * WILD_TEST_T, "flash": 3 * 2 * WILD_TEST_T}
    want_predict = {"wrap": 6 * WILD_TEST_T, "flash": 3 * WILD_TEST_T}
    step_ms = [r["ms"] for r in records]
    gaps = [(b["start"] - a["start"]) * 1e3 for a, b in zip(records, records[1:])
            if b["step"] == a["step"] + 1]
    B = opt["datasets"]["train"]["batch_size"]
    emit(phase="train_wild", what=f"cli.train_restoration -opt configs/wild-ir/train.yml "
         f"({WILD_STEPS} steps, resume to {WILD_RESUME_STEPS}, validation and checkpoints "
         f"every {WILD_VAL_FREQ})",
         config=dict(B=B, patch=opt["datasets"]["train"]["patch_size"],
                     n_workers=opt["datasets"]["train"]["n_workers"], mode="MDGT",
                     gt_images=f"{WILD_GT[0]} at {WILD_GT[1][0]}x{WILD_GT[1][1]} (Up rows)",
                     val_images="2 at 256x256", val_sample_T=WILD_VAL_T,
                     unet=opt["network_G"]["setting"], daclip=WILD_DACLIP,
                     daclip_pt_bytes=pt_bytes),
         setup_s=setup_s, train_s=train_s, first=first, second=second,
         steps_run=[r["step"] for r in records], checkpoints=ckpts, ms_per_step=step_ms,
         median_ms_per_step=float(np.median(step_ms)),
         median_ms_step_to_step=float(np.median(gaps)),
         samples_per_s_step_to_step=B * 1e3 / float(np.median(gaps)),
         loader_samples_per_s=loader, synthesis_256=synth, validations=n_val,
         frozen_daclip_unchanged=frozen, launches=calls, want_launches=want,
         max_memory_allocated=peak)
    emit(phase="test_wild", what=f"cli.test_restoration -opt configs/wild-ir/test.yml, "
         f"T={WILD_TEST_T}, the EMA UNet of train_wild; then cli.predict --wild-ir on the "
         "256² LQ", images=["256x256", "200x300"], psnr=summary["psnr"],
         ssim=summary["ssim"], ms_per_image=[float(v) * 1e3 for v in summary["time"]],
         test_s=test_s, saved_shapes=saved_shapes, launches=test_calls,
         want_launches=want_test, predict_s=predict_s, predict_shape=list(restored.shape),
         predict_launches=predict_calls, want_predict_launches=want_predict)
    emit(phase="wild_tools", what="tools.generate_lq (each type, 2 images "
         f"{WILD_GT[1][0]}x{WILD_GT[1][1]}, crop 256) and tools.generate_masked (2 images)",
         seconds=tools, levels=len(level_dirs), files=len(outputs),
         shapes=sorted(map(str, shapes)), masked=masked)
    check(first["final_step"] == WILD_STEPS and second["final_step"] == WILD_RESUME_STEPS,
          f"train_wild ended at {first['final_step']} and {second['final_step']}")
    check(np.isfinite([first["best_psnr"], second["best_psnr"]]).all(),
          "train_wild: a validation PSNR is not finite")
    check(records[0]["step"] == 0 and records[n_first]["step"] == WILD_STEPS
          and len(records) == WILD_RESUME_STEPS,
          f"train_wild ran steps {[r['step'] for r in records]}")
    check({f"{s}.pt" for s in (WILD_VAL_FREQ, WILD_STEPS, WILD_RESUME_STEPS)} <= set(ckpts),
          f"train_wild checkpoints: {ckpts}")
    check(n_loaded == 2 and frozen, f"train_wild: the frozen DA-CLIP's contexts changed "
          f"({n_loaded} loads)")
    check(calls == want, f"train_wild: kernel calls {calls}, expected {want}")
    check(len(summary["psnr"]) == 2 and all(np.isfinite(v).all() for v in summary.values()),
          "test_wild: metrics not finite")
    check(saved_shapes == [(256, 256, 3), (200, 300, 3)] and saved_finite,
          f"test_wild saved {saved_shapes}")
    check(test_calls == want_test, f"test_wild: kernel calls {test_calls}, expected {want_test}")
    check(restored.shape == (256, 256, 3), f"predict --wild-ir wrote {restored.shape}")
    check(predict_calls == want_predict,
          f"predict --wild-ir: kernel calls {predict_calls}, expected {want_predict}")
    # 36 levels each of blur, noisy and resize (1-39 without 10, 20, 30), 8 of jpeg
    check(len(level_dirs) == 3 * 36 + 8 and len(prompts) == len(level_dirs)
          and all(len(p) == 2 for p in prompts), f"generate_lq wrote {len(level_dirs)} levels")
    check(len(outputs) == 4 * len(level_dirs) + 4 and masked == 2,
          f"the tools wrote {len(outputs)} images, masked {masked}")
    check(shapes <= {(256, 256, 3), (512, 512, 3), WILD_GT[1] + (3,)},
          f"tool outputs decode to {shapes}")
    return rows, {"wild_ir_train": calls, "wild_ir_test": test_calls,
                  "wild_ir_predict": predict_calls}


# -- phase 12 ------------------------------------------------------------------
DACLIP_MODEL = "daclip_ViT-B-32"   # vision 768 × 12, patch 32, 224²; text 512 × 12, 77 tokens
DACLIP_B, DACLIP_ACCUM = 512, 2
DACLIP_F32_B = 8
DACLIP_F32_LIMIT = 1e-4   # f32 card vs f32 CPU, one step: loss and params, of their max
# the same step's update p_after - p_before, of its max: 2.4e-3 read on an NVIDIA
# H100 80GB HBM3 at 700 W; a skipped step reads 1
DACLIP_UPDATE_LIMIT = 1e-2


def clip_batch(B, seed, device, res=224, L=77):
    """A seeded DA-CLIP batch: 224² CLIP-normalised LQ and GT images,
    tokenised "caption| degradation" texts, deg_type / gt_val with every
    type present."""
    from daclip_torch.tokenizer import tokenize
    from daclip_torch.transforms import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD

    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.RandomState(seed)
    mean = torch.tensor(OPENAI_DATASET_MEAN, device=device).view(1, 3, 1, 1)
    std = torch.tensor(OPENAI_DATASET_STD, device=device).view(1, 3, 1, 1)
    image = lambda: (torch.rand(B, 3, res, res, generator=gen, device=device) - mean) / std
    types = ["blur", "noisy", "resize", "jpeg"]
    lows, highs = np.array([0.5, 5, 0.5, 10]), np.array([4, 40, 4, 80])
    deg_type = (rng.rand(B, 4) > 0.5).astype(np.float32)
    deg_type[np.arange(B), np.arange(B) % 4] = 1.0          # every type present
    gt_val = (deg_type * (lows + rng.rand(B, 4) * (highs - lows))).astype(np.float32)
    caps = [f"a photo of scene {i}, outdoors" for i in range(B)]
    degs = [", ".join(f"{t} with parameter {v:.1f}" for t, v, m in zip(types, g, d) if m)
            for g, d in zip(gt_val, deg_type)]
    texts = np.concatenate([tokenize(caps, context_length=L),
                            tokenize(degs, context_length=L)], axis=1)
    return {"images": image(), "gt_images": image(),
            "texts": torch.from_numpy(texts).to(device),
            "deg_type": torch.from_numpy(deg_type).to(device),
            "gt_val": torch.from_numpy(gt_val).to(device)}


def daclip_model(dtype_name, device, sd, patch_dropout=None):
    from daclip_torch.factory import create_model

    model = create_model(DACLIP_MODEL, precision=dtype_name, use_predictor=True,
                         force_patch_dropout=patch_dropout)
    model.load_state_dict(sd, strict=True)
    return model.to(device)


def run_train_daclip(steps=5, warmup=2):
    """The fork's DA-CLIP training step at full width: daclip_ViT-B-32 with
    the level predictor, bf16 (--precision amp), B = 512, AdamW lr 2e-5,
    wd 0.2, betas 0.9/0.98, eps 1e-6, cosine with warm-up (README's launch
    line), seeded weights and batch; then one f32 step at B = 8 on the card
    against the same on the CPU, and one accum_freq 2 step at 2 × 256."""
    import gc

    from daclip_torch.data.csv_dataset import build_banks
    from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config
    from daclip_torch.tokenizer import tokenize
    from daclip_torch.train.clip_train import (ClipTrainConfig, init_state,
                                               make_accum_train_step, make_train_step)

    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    clip_cfg = CLIPCfg.from_dict(get_model_config(DACLIP_MODEL))
    sd = seeded_state_dict(lambda: DaCLIP(clip_cfg, use_predictor=True), seed=31)
    banks = build_banks(partial(tokenize, context_length=clip_cfg.text.context_length))
    cfg = ClipTrainConfig(lr=2e-5, wd=0.2, beta1=0.9, beta2=0.98, eps=1e-6, variant="fork")
    t0 = time.perf_counter()
    model = daclip_model("amp", "cuda", sd)
    state = init_state(model, cfg, device="cuda")
    step_fn = make_train_step(model, cfg, banks, device="cuda")
    setup_s = time.perf_counter() - t0
    frozen0 = {k: v.clone() for k, v in model.state_dict().items()
               if k.startswith(("clip.", "visual."))}
    shape = dict(res=clip_cfg.vision.image_size, L=clip_cfg.text.context_length)
    batch = clip_batch(DACLIP_B, seed=32, device="cuda", **shape)
    for _ in range(warmup):
        step_fn(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    ms, metrics = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        _, m = step_fn(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()
    step_ms = float(np.median(ms))
    prof = profile_one(lambda: step_fn(state, batch), step_ms, n_top=12)
    frozen_same = all(torch.equal(v, model.state_dict()[k]) for k, v in frozen0.items())
    last = metrics[-1]
    emit(phase="train_daclip", what=f"the fork's training step, {DACLIP_MODEL} with the "
         f"predictor, bf16, B={DACLIP_B} ({warmup} warm-up, {steps} timed steps, host clock "
         "to a synchronize)",
         config=dict(model=DACLIP_MODEL, B=DACLIP_B, precision="amp", lr=cfg.lr, wd=cfg.wd,
                     betas=[cfg.beta1, cfg.beta2], eps=cfg.eps, warmup=cfg.warmup,
                     scheduler=cfg.lr_scheduler),
         trainable_params=sum(p.numel() for _, p in state.params),
         params=sum(p.numel() for p in model.parameters()), setup_s=setup_s,
         ms_per_step=ms, median_ms_per_step=step_ms, samples_per_s=DACLIP_B * 1e3 / step_ms,
         max_memory_allocated=peak, memory_allocated_before=resident, metrics=metrics,
         frozen_clip_unchanged=frozen_same, profile=prof)
    check(all(np.isfinite(list(m.values())).all() for m in metrics),
          "train_daclip: a loss term is not finite")
    check(last["fcrc_loss"] > 0, f"train_daclip: FCRC {last['fcrc_loss']}")
    check(frozen_same, "train_daclip: the frozen CLIP changed")
    check(1.0 <= last["logit_scale"] <= 100.0, f"logit_scale {last['logit_scale']}")

    # the accumulation two-pass at 2 × 256, on the same model and batch
    accum_cfg = dataclasses.replace(cfg, accum_freq=DACLIP_ACCUM)
    accum_fn = make_accum_train_step(model, accum_cfg, banks, device="cuda")
    half = DACLIP_B // DACLIP_ACCUM
    micro = [{k: v[i * half:(i + 1) * half] for k, v in batch.items()}
             for i in range(DACLIP_ACCUM)]
    accum_fn(state, micro)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, m = accum_fn(state, micro)
    torch.cuda.synchronize()
    accum_ms = (time.perf_counter() - t0) * 1e3
    accum = {k: float(v) for k, v in m.items()}
    emit(phase="train_daclip", what=f"accum_freq {DACLIP_ACCUM} two-pass step at "
         f"{DACLIP_ACCUM} x {half}", ms=accum_ms, metrics=accum,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         max_memory_allocated_b512=peak)
    check(np.isfinite(list(accum.values())).all(), "the accum step is not finite")
    counts = read_counts()
    check(not any(counts.values()), f"train_daclip launched hand kernels: {counts}")
    del model, state, step_fn, accum_fn, batch, micro, frozen0
    gc.collect()
    torch.cuda.empty_cache()

    f32 = daclip_f32_step(cfg, sd, banks, shape)
    emit(phase="train_daclip", what=f"one f32 step, card vs CPU, B={DACLIP_F32_B}", **f32,
         limit=DACLIP_F32_LIMIT, update_limit=DACLIP_UPDATE_LIMIT)
    check(f32["loss_rel_err"] <= DACLIP_F32_LIMIT,
          f"train_daclip f32 loss: card vs CPU {f32['loss_rel_err']}")
    check(f32["params_err_of_max"] <= DACLIP_F32_LIMIT,
          f"train_daclip f32 params: {f32['params_err_of_max']} of their max")
    check(f32["update_err_of_max"] <= DACLIP_UPDATE_LIMIT,
          f"train_daclip f32 update: {f32['update_err_of_max']} of its max "
          f"(worst {f32['update_worst']})")
    counts = read_counts()
    check(not any(counts.values()), f"train_daclip launched hand kernels: {counts}")
    return dict(step_ms=step_ms, samples_per_s=DACLIP_B * 1e3 / step_ms, peak=peak, sd=sd,
                banks=banks, shape=shape, cfg=cfg)



def daclip_f32_step(cfg, sd, banks, shape, patch_dropout=None):
    """One f32 step (TF32 off) from the seeded weights on a seeded B = 8
    batch, on the card and on the CPU: the loss, the trainable parameters
    and the update (p_after - p_before), card against CPU, each as a share
    of its max. A card step that changed nothing reads an update error of 1.
    With `patch_dropout` (and `cfg.patch_dropout`), both devices take the
    same patch noise: the i-th draw is drawn on the CPU from seed i.

    The step runs at lr 1e-3 and Adam eps 1e-3, as the CPU tests do. The
    key projection's bias has a gradient that is 0 up to rounding; at eps
    1e-6 Adam's first step turns its sign into +-lr on either device. At
    lr 1e-3 the update is ~4000 ulps of the largest parameter (logit_scale,
    2.66), so rounding p + u adds ~2.4e-4 of the update's max; the f32
    gradients' different sums on the two devices add the rest."""
    from daclip_torch.train.clip_train import init_state, make_train_step

    import itertools

    from daclip_torch.models.transformer import VisionTransformer

    f32 = dataclasses.replace(cfg, lr=1e-3, eps=1e-3, warmup=1)  # the first step at full lr
    small = clip_batch(DACLIP_F32_B, seed=33, device="cpu", **shape)
    out = {}
    real_noise = VisionTransformer.patch_dropout_noise
    try:
        for device in ("cuda", "cpu"):
            seeds = itertools.count()
            VisionTransformer.patch_dropout_noise = lambda self, size, dev, generator=None: (
                torch.randn(size, generator=torch.Generator().manual_seed(next(seeds))).to(dev))
            model = daclip_model("fp32", device, {k: v.to(device) for k, v in sd.items()},
                                 patch_dropout)
            state = init_state(model, f32, device=device)
            _, m = make_train_step(model, f32, banks, device=device)(
                state, {k: v.to(device) for k, v in small.items()})
            out[device] = (float(m["total_loss"]),
                           {n: p.detach().float().cpu() for n, p in state.params}, next(seeds))
            del model, state
    finally:
        VisionTransformer.patch_dropout_noise = real_noise
    check(out["cuda"][2] == out["cpu"][2] == (3 if patch_dropout else 0),
          f"patch noise draws: card {out['cuda'][2]}, CPU {out['cpu'][2]}")
    card, cpu = out["cuda"][1], out["cpu"][1]
    update = {n: (card[n] - sd[n].float().cpu(), p - sd[n].float().cpu())
              for n, p in cpu.items()}
    u_err = {n: float((uc - u).abs().max()) for n, (uc, u) in update.items()}
    u_max = max(float(u.abs().max()) for _, u in update.values())
    p_err = max(float((card[n] - p).abs().max()) for n, p in cpu.items())
    p_max = max(float(p.abs().max()) for p in cpu.values())
    worst = max(u_err, key=u_err.get)
    return dict(lr=f32.lr, eps=f32.eps, loss_card=out["cuda"][0], loss_cpu=out["cpu"][0],
                loss_rel_err=abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0]),
                params_max_abs_err=p_err, params_max=p_max, params_err_of_max=p_err / p_max,
                update_max_abs_err=u_err[worst], update_max=u_max,
                update_err_of_max=u_err[worst] / u_max, update_worst=worst)

# -- phase 13 ------------------------------------------------------------------
# train and val LQ/GT pairs (24 train pairs before, cut for the script's
# time when the shard_tiles phase came; the same half Up, half Paeth rows)
CLIP_TREE = (16, 8)
CLIP_SIDES = (224, 288)        # image sides, drawn per image
CLIP_CLI_B, CLIP_CLI_WORKERS = 8, 4
# 1 epoch and a resume to 2 (2 and 3 before, cut for the script's time)
CLIP_CLI_EPOCHS = 1


def write_clip_tree(root, pairs, seed, filters=("up", "paeth")):
    """`root/{LQ,GT}/<i>.png` (sides drawn from CLIP_SIDES, pair i with the
    row filter filters[i % len(filters)]: the even pairs Up, the odd Paeth)
    and a TSV of their paths and "caption| degradation" titles."""
    from daclip_torch.data import png

    rng = np.random.RandomState(seed)
    types = ["blur", "noisy", "resize", "jpeg"]
    lows, highs = np.array([0.5, 5, 0.5, 10]), np.array([4, 40, 4, 80])
    for sub in ("LQ", "GT"):
        (root / sub).mkdir(parents=True)
    rows = []
    for i in range(pairs):
        h, w = rng.randint(CLIP_SIDES[0], CLIP_SIDES[1] + 1, 2)
        gt = rng.rand(h, w, 3)
        lq = np.clip(gt + 0.1 * rng.randn(h, w, 3), 0, 1)
        for sub, img in (("GT", gt), ("LQ", lq)):
            png.write(str(root / sub / f"{i:03d}.png"), (img * 255).round().astype(np.uint8),
                      filters[i % len(filters)])
        present = rng.rand(4) > 0.5
        present[i % 4] = True
        vals = lows + rng.rand(4) * (highs - lows)
        deg = ", ".join(f"{t} with parameter {v:.1f}" for t, v, m in zip(types, vals, present)
                        if m)
        rows.append(f"{root / 'LQ' / f'{i:03d}.png'}\ta photo of scene {i}| {deg}")
    (root / "data.csv").write_text("filepath\ttitle\n" + "\n".join(rows) + "\n")
    return str(root / "data.csv")


def timed_steps(make_step, records):
    """`make_step` whose steps append {step, start, ms} to `records`: each
    step timed on the host clock between two synchronizes."""
    def timed_make(*args, **kw):
        step = make_step(*args, **kw)

        def timed(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            before = state.step
            out = step(state, batch)
            torch.cuda.synchronize()
            records.append(dict(step=before, start=t0, ms=(time.perf_counter() - t0) * 1e3))
            return out

        return timed

    return timed_make


def step_to_step_ms(records):
    return [(b["start"] - a["start"]) * 1e3 for a, b in zip(records, records[1:])
            if b["step"] == a["step"] + 1]


def run_train_daclip_cli(train_daclip_ms):
    """`daclip_torch.cli.train_daclip.main` in process: --da, daclip_ViT-B-32,
    --precision amp, seeded weights, a seeded CSV of 16 LQ/GT PNG pairs and a
    val CSV of 8, batch 8, 4 workers, 1 epoch, then --resume latest to 2;
    the step timed by a hook on the trainer's `make_train_step`; the
    loader's samples/s alone before; the last checkpoint through
    DACLIPRestorer.load with a seeded production UNet, which classifies."""
    import gc
    import json as json_mod
    import random
    import tempfile

    from daclip_torch.cli import train_daclip as cli
    from daclip_torch.data.csv_dataset import CsvDataset
    from daclip_torch.data.loader import DataLoader
    from daclip_torch.models.clip import CLIPCfg, get_model_config
    from daclip_torch.models.unet import ConditionalUNet
    from daclip_torch.pipeline import DEGRADATION_CLASSES, DACLIPRestorer, RestorerConfig
    from daclip_torch.tokenizer import tokenize
    from daclip_torch.train import clip_train
    from daclip_torch.transforms import image_transform
    from daclip_torch.utils import checkpoint as ckpt

    gc.collect()
    torch.cuda.empty_cache()
    records = []
    real_make = clip_train.make_train_step
    timed_make = timed_steps(real_make, records)

    with tempfile.TemporaryDirectory() as d:
        root = pathlib.Path(d)
        t0 = time.perf_counter()
        train_csv = write_clip_tree(root / "train", CLIP_TREE[0], seed=41)
        val_csv = write_clip_tree(root / "val", CLIP_TREE[1], seed=42)
        unet_kw = dict(nf=64, ch_mult=(1, 2, 4, 8), context_dim=512, use_degra_context=True,
                       use_image_context=True)
        unet_pth = root / "unet.pth"
        torch.save({k: v.cpu() for k, v in seeded_state_dict(
            lambda: ConditionalUNet(**unet_kw), seed=1).items()}, unet_pth)
        setup_s = time.perf_counter() - t0

        res = CLIPCfg.from_dict(get_model_config(DACLIP_MODEL)).vision.image_size
        ds = CsvDataset(train_csv, image_transform(res, is_train=True), da=True, seed=0)
        loader = DataLoader(ds, batch_size=CLIP_CLI_B, shuffle=True,
                            num_workers=CLIP_CLI_WORKERS)
        t0 = time.perf_counter()
        n = sum(len(b["images"]) for b in loader)
        loader_sps = n / (time.perf_counter() - t0)

        argv = ["--train-data", train_csv, "--val-data", val_csv, "--da", "--model",
                DACLIP_MODEL, "--precision", "amp", "--batch-size", str(CLIP_CLI_B),
                "--workers", str(CLIP_CLI_WORKERS), "--logs", str(root / "logs"),
                "--name", "cli", "--lr", "2e-5", "--device", "cuda"]
        reset_counts()
        clip_train.make_train_step = timed_make
        t0 = time.perf_counter()
        try:
            first = cli.main(argv + ["--epochs", str(CLIP_CLI_EPOCHS)])
            n_first = len(records)
            second = cli.main(argv + ["--epochs", str(CLIP_CLI_EPOCHS + 1), "--resume",
                                      "latest"])
        finally:
            clip_train.make_train_step = real_make
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = read_counts()
        ckpt_dir = root / "logs" / "cli" / "checkpoints"
        epochs = ckpt.steps(str(ckpt_dir), ckpt.EPOCH)
        best = ckpt.steps(str(ckpt_dir / "best"), ckpt.EPOCH)
        rows = [json_mod.loads(x) for x in
                (root / "logs" / "cli" / "results.jsonl").read_text().splitlines()]
        val_rows = [r for r in rows if "val/image_to_text_R@1" in r]
        last = torch.load(ckpt.checkpoint_path(str(ckpt_dir), CLIP_CLI_EPOCHS + 1, ckpt.EPOCH),
                          map_location="cpu",
                          weights_only=False)
        restorer = DACLIPRestorer.load(str(unet_pth), ckpt.checkpoint_path(
            str(ckpt_dir), CLIP_CLI_EPOCHS + 1, ckpt.EPOCH), RestorerConfig(model_name=DACLIP_MODEL, linear_attention="v5",
                                pointwise=False), device="cuda")
        name, probs = restorer.classify_degradation(
            np.random.RandomState(43).rand(256, 256, 3).astype(np.float32))
        counts_after = read_counts()
        del restorer
        from daclip_torch.tools import inspect_checkpoint as insp

        tree, fmt = insp.load_tree(str(ckpt_dir))
        inspected = dict(insp.describe(tree, fmt, limit=3, _print=lambda line: None), format=fmt)
        del tree

        # --fast-clip-view: the loader alone with cv2's decode and view, then
        # one epoch of the CLI without a val set
        fast_ds = CsvDataset(train_csv, image_transform(res, is_train=True, backend="cv2",
                                                        rng=random.Random(0)),
                             da=True, seed=0, decode="cv2")
        loader = DataLoader(fast_ds, batch_size=CLIP_CLI_B, shuffle=True,
                            num_workers=CLIP_CLI_WORKERS)
        t0 = time.perf_counter()
        n = sum(len(b["images"]) for b in loader)
        fast_loader_sps = n / (time.perf_counter() - t0)
        fast_argv = ["--train-data", train_csv, "--da", "--model", DACLIP_MODEL, "--precision",
                     "amp", "--batch-size", str(CLIP_CLI_B), "--workers", str(CLIP_CLI_WORKERS),
                     "--logs", str(root / "logs"), "--name", "fast", "--lr", "2e-5",
                     "--epochs", "1", "--fast-clip-view", "--device", "cuda"]
        reset_counts()
        t0 = time.perf_counter()
        fast = cli.main(fast_argv)
        torch.cuda.synchronize()
        fast_s = time.perf_counter() - t0
        fast_counts = read_counts()
        fast_epochs = ckpt.steps(str(root / "logs" / "fast" / "checkpoints"), ckpt.EPOCH)
    emit(phase="fast_clip_view", what="cli.train_daclip.main --fast-clip-view: one epoch "
         "(cv2 decode and view), no val set; the loader alone beside the PIL path's",
         config=dict(model=DACLIP_MODEL, precision="amp", B=CLIP_CLI_B,
                     workers=CLIP_CLI_WORKERS, train_pairs=CLIP_TREE[0]),
         loader_samples_per_s_cv2=fast_loader_sps, loader_samples_per_s_pil=loader_sps,
         cv2_over_pil=fast_loader_sps / loader_sps, train_s=fast_s, result=fast,
         checkpoints=fast_epochs, launches=fast_counts)
    check(np.isfinite(fast["best_loss"]) and fast_epochs == [1],
          f"--fast-clip-view: loss {fast['best_loss']}, checkpoints {fast_epochs}")
    check(not any(fast_counts.values()), f"--fast-clip-view launched hand kernels: "
          f"{fast_counts}")
    step_ms = [r["ms"] for r in records]
    gaps = step_to_step_ms(records)
    emit(phase="train_daclip_cli", what=f"cli.train_daclip.main: {CLIP_CLI_EPOCHS} epoch, then "
         f"--resume latest to {CLIP_CLI_EPOCHS + 1}, val every epoch",
         config=dict(model=DACLIP_MODEL, precision="amp", B=CLIP_CLI_B,
                     workers=CLIP_CLI_WORKERS, train_pairs=CLIP_TREE[0],
                     val_pairs=CLIP_TREE[1], sides=list(CLIP_SIDES),
                     png_rows="half Up, half Paeth"),
         cuts=dict(batch=f"{CLIP_CLI_B}, not {DACLIP_B} (the host's PNG decode; the "
                   "full-width step is train_daclip's)",
                   tree=f"{CLIP_TREE[0]} + {CLIP_TREE[1]} pairs"),
         setup_s=setup_s, train_s=train_s, first=first, second=second,
         steps_run=[r["step"] for r in records], ms_per_step=step_ms,
         median_ms_per_step=float(np.median(step_ms)),
         median_ms_step_to_step=float(np.median(gaps)),
         samples_per_s_step_to_step=CLIP_CLI_B * 1e3 / float(np.median(gaps)),
         loader_samples_per_s_alone=loader_sps, train_daclip_median_ms_b512=train_daclip_ms,
         checkpoints=epochs, best=best, last_step=last["step"], val_rows=val_rows,
         classified=name, top_probability=max(probs.values()), launches=counts)
    steps_per_epoch = CLIP_TREE[0] // CLIP_CLI_B
    total = CLIP_CLI_EPOCHS + 1
    check(epochs == list(range(1, total + 1)) and len(best) == 1,
          f"checkpoints {epochs}, best {best}")
    check(last["step"] == total * steps_per_epoch and len(records) == total * steps_per_epoch
          and records[n_first]["step"] == CLIP_CLI_EPOCHS * steps_per_epoch,
          f"train_daclip_cli ran steps {[r['step'] for r in records]}")
    check(len(val_rows) == total and all(np.isfinite(list(r.values())).all() for r in val_rows),
          "train_daclip_cli: val metrics missing or not finite")
    check(np.isfinite([first["best_loss"], second["best_loss"]]).all(),
          "train_daclip_cli: a train loss is not finite")
    check(name in DEGRADATION_CLASSES, f"classified as {name}")
    check(not any(counts.values()) and not any(counts_after.values()),
          f"train_daclip_cli launched hand kernels: {counts} / {counts_after}")
    return inspected


# -- phase 13b -----------------------------------------------------------------
PATCH_DROPOUT = 0.5


def run_patch_dropout(base, steps=5, warmup=2):
    """train_daclip's step with --force-patch-dropout 0.5: the same seeded
    daclip_ViT-B-32 with the predictor, bf16, B = 512, the same batch; the
    tokens each tower's ln_pre sees with and without `train`; the step's ms,
    samples/s and peak memory beside train_daclip's (`base`); then the f32
    step at B = 8 with one patch noise on the card and the CPU."""
    import gc

    from daclip_torch.train.clip_train import init_state, make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    cfg = dataclasses.replace(base["cfg"], patch_dropout=True)
    model = daclip_model("amp", "cuda", base["sd"], PATCH_DROPOUT)
    state = init_state(model, cfg, device="cuda")
    step_fn = make_train_step(model, cfg, base["banks"], device="cuda")
    batch = clip_batch(DACLIP_B, seed=32, device="cuda", **base["shape"])
    grid = (base["shape"]["res"] // model.cfg.vision.patch_size) ** 2
    tokens = {"visual_control": [], "visual": []}
    hooks = [getattr(model, name).ln_pre.register_forward_hook(
        lambda m, i, o, name=name: tokens[name].append(int(o.shape[1]))) for name in tokens]
    step_fn(state, batch)
    dropped = {k: list(v) for k, v in tokens.items()}
    for v in tokens.values():
        v.clear()
    with torch.no_grad():
        model.encode_image(batch["images"][:2], control=True)
    kept_all = {k: list(v) for k, v in tokens.items()}
    for h in hooks:
        h.remove()
    for _ in range(warmup - 1):
        step_fn(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, metrics = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        _, m = step_fn(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()
    step_ms = float(np.median(ms))
    counts = read_counts()
    keep = max(1, int(grid * (1 - PATCH_DROPOUT)))
    emit(phase="patch_dropout", what=f"train_daclip's step with --force-patch-dropout "
         f"{PATCH_DROPOUT} ({warmup} warm-up, {steps} timed steps, host clock to a "
         "synchronize), beside train_daclip's step in this run",
         config=dict(model=DACLIP_MODEL, B=DACLIP_B, precision="amp",
                     patch_dropout=PATCH_DROPOUT),
         ln_pre_tokens_train=dropped, ln_pre_tokens_eval=kept_all, ms_per_step=ms,
         median_ms_per_step=step_ms, samples_per_s=DACLIP_B * 1e3 / step_ms,
         max_memory_allocated=peak, no_dropout_median_ms_per_step=base["step_ms"],
         no_dropout_samples_per_s=base["samples_per_s"],
         no_dropout_max_memory_allocated=base["peak"], over_no_dropout=step_ms / base["step_ms"],
         metrics=metrics, launches=counts)
    # the controller once; the frozen tower for the images and the GT images
    check(dropped == {"visual_control": [1 + keep], "visual": [1 + keep] * 2},
          f"patch dropout: ln_pre saw {dropped}, expected 1 + {keep} tokens")
    check(kept_all == {"visual_control": [1 + grid], "visual": [1 + grid]},
          f"patch dropout: ln_pre without train saw {kept_all}, expected 1 + {grid}")
    check(all(np.isfinite(list(m.values())).all() for m in metrics),
          "patch_dropout: a loss term is not finite")
    check(not any(counts.values()), f"patch_dropout launched hand kernels: {counts}")
    del model, state, step_fn, batch
    gc.collect()
    torch.cuda.empty_cache()

    f32 = daclip_f32_step(cfg, base["sd"], base["banks"], base["shape"], PATCH_DROPOUT)
    emit(phase="patch_dropout", what=f"one f32 step with patch dropout, card vs CPU on one "
         f"patch noise, B={DACLIP_F32_B}", **f32, limit=DACLIP_F32_LIMIT,
         update_limit=DACLIP_UPDATE_LIMIT)
    check(f32["loss_rel_err"] <= DACLIP_F32_LIMIT,
          f"patch_dropout f32 loss: card vs CPU {f32['loss_rel_err']}")
    check(f32["params_err_of_max"] <= DACLIP_F32_LIMIT,
          f"patch_dropout f32 params: {f32['params_err_of_max']} of their max")
    check(f32["update_err_of_max"] <= DACLIP_UPDATE_LIMIT,
          f"patch_dropout f32 update: {f32['update_err_of_max']} of its max "
          f"(worst {f32['update_worst']})")
    counts = read_counts()
    check(not any(counts.values()), f"patch_dropout launched hand kernels: {counts}")


# -- phase 13c -----------------------------------------------------------------
WDS_MODEL = "ViT-B-32"         # webdataset refuses --da, so a plain CLIP
WDS_SHARDS, WDS_PER_SHARD = 4, 8
WDS_ZS = (["blurry", "noisy", "rainy", "hazy"], 4)   # the zero-shot tree: classes, images
WDS_EPOCHS = 2


def write_wds_shards(root, shards, per_shard, seed):
    """`root/shard-<s>.tar` of (png, txt) samples: seeded images with sides
    drawn from CLIP_SIDES, every row Up-filtered; returns the brace pattern."""
    import io
    import tarfile

    from daclip_torch.data import png

    rng = np.random.RandomState(seed)
    root.mkdir(parents=True)
    scratch = root / "sample.png"
    for s in range(shards):
        with tarfile.open(root / f"shard-{s:03d}.tar", "w") as tf:
            for i in range(per_shard):
                h, w = rng.randint(CLIP_SIDES[0], CLIP_SIDES[1] + 1, 2)
                png.write(str(scratch), (rng.rand(h, w, 3) * 255).round().astype(np.uint8), "up")
                tf.add(str(scratch), arcname=f"{s:03d}_{i:03d}.png")
                text = f"a photo of scene {s}-{i}, outdoors".encode()
                info = tarfile.TarInfo(f"{s:03d}_{i:03d}.txt")
                info.size = len(text)
                tf.addfile(info, io.BytesIO(text))
    scratch.unlink()
    return str(root / ("shard-{000..%03d}.tar" % (shards - 1)))


def seeded_tag(cache, seed):
    """A seeded ViT-B-32 CLIP `.pt` in `cache`, under an OpenAI-style URL that
    names its sha256, registered as the tag "seeded" of ViT-B-32 (the caller
    removes it). Returns (url, state dict)."""
    import hashlib

    from daclip_torch.models import pretrained
    from daclip_torch.models.clip import CLIP, CLIPCfg, get_model_config

    sd = {k: v.cpu() for k, v in seeded_state_dict(
        lambda: CLIP(CLIPCfg.from_dict(get_model_config(WDS_MODEL))), seed).items()}
    cache.mkdir(parents=True)
    tmp = cache / "tmp.pt"
    torch.save(sd, tmp)
    h = hashlib.sha256(tmp.read_bytes()).hexdigest()
    url = f"https://openaipublic.azureedge.net/clip/models/{h}/ViT-B-32-seeded.pt"
    tmp.rename(cache / "ViT-B-32-seeded.pt")
    pretrained._PRETRAINED[WDS_MODEL]["seeded"] = pretrained._pcfg(url)
    return url, sd


def file_digest(path):
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def tree(top):
    """{relative path: size} of the files under `top` but out.log (which
    grows with the final sync's own log lines after it is copied): what the
    sync compares."""
    return {str(p.relative_to(top)): p.stat().st_size for p in top.rglob("*")
            if p.is_file() and p.name != "out.log"}


def run_train_daclip_wds():
    """cli.train_daclip.main in process on a plain ViT-B-32, bf16, over 4 seeded
    tar shards of PNG + txt (32 samples), B = 8, --force-patch-dropout 0.5,
    ImageNet zero-shot every epoch on a seeded 4-class tree, --remote-sync to
    a local path by fsspec, 2 epochs; then the local checkpoints deleted and
    --resume latest to 3, which fetches them from the remote. Its weights are
    a registry tag: a seeded .pt in a cache dir under a URL that names its
    sha256, loaded through download_pretrained_from_url and the factory with
    urlopen refusing any call (a cache miss fails the phase)."""
    import gc
    import json as json_mod
    import shutil
    import urllib.request
    from functools import partial as part

    from daclip_torch.cli import train_daclip as cli
    from daclip_torch.data.webdataset import ClipWebLoader, WebDataset
    from daclip_torch.factory import create_model
    from daclip_torch.models import pretrained
    from daclip_torch.tokenizer import tokenize
    from daclip_torch.train import clip_train
    from daclip_torch.transforms import image_transform
    from daclip_torch.utils import checkpoint as ckpt

    gc.collect()
    torch.cuda.empty_cache()
    records = []
    real_make, real_urlopen = clip_train.make_train_step, urllib.request.urlopen

    def no_network(*a, **k):
        raise RuntimeError("train_daclip_wds: a pretrained download was attempted")

    with tempfile.TemporaryDirectory() as d:
        root = pathlib.Path(d)
        t0 = time.perf_counter()
        pattern = write_wds_shards(root / "shards", WDS_SHARDS, WDS_PER_SHARD, seed=51)
        write_class_tree(root / "zs", WDS_ZS[0], WDS_ZS[1], CLIP_SIDES, seed=52, layout="")
        urllib.request.urlopen = no_network
        try:
            url, sd = seeded_tag(root / "cache", seed=53)
            path = pretrained.download_pretrained_from_url(url, cache_dir=str(root / "cache"))
            tagged = create_model(WDS_MODEL, pretrained="seeded", cache_dir=str(root / "cache"))
        finally:
            urllib.request.urlopen = real_urlopen
            pretrained._PRETRAINED[WDS_MODEL].pop("seeded", None)
        loaded = all(torch.equal(tagged.state_dict()[k], v) for k, v in sd.items())
        del tagged, sd
        setup_s = time.perf_counter() - t0

        res = 224
        loader = ClipWebLoader(WebDataset(pattern, shuffle_buffer=5000, seed=0),
                               image_transform(res, is_train=True),
                               part(tokenize, context_length=77), CLIP_CLI_B,
                               WDS_SHARDS * WDS_PER_SHARD)
        t0 = time.perf_counter()
        n = sum(len(b["images"]) for b in loader)
        loader_sps = n / (time.perf_counter() - t0)

        logs, remote = root / "logs", root / "remote"
        argv = ["--train-data", pattern, "--train-num-samples",
                str(WDS_SHARDS * WDS_PER_SHARD), "--model", WDS_MODEL, "--pretrained", path,
                "--precision", "amp", "--batch-size", str(CLIP_CLI_B), "--logs", str(logs),
                "--name", "wds", "--lr", "2e-5", "--device", "cuda", "--force-patch-dropout",
                str(PATCH_DROPOUT), "--imagenet-val", str(root / "zs"),
                "--zeroshot-frequency", "1", "--remote-sync", str(remote),
                "--remote-sync-protocol", "fsspec"]
        reset_counts()
        clip_train.make_train_step = timed_steps(real_make, records)
        t0 = time.perf_counter()
        try:
            first = cli.main(argv + ["--epochs", str(WDS_EPOCHS)])
            run_dir, remote_dir = logs / "wds", remote / "wds"
            mirrored = tree(run_dir) == tree(remote_dir)
            saved = file_digest(run_dir / "checkpoints" / "epoch_2.pt")
            n_first = len(records)
            shutil.rmtree(run_dir / "checkpoints")
            second = cli.main(argv + ["--epochs", str(WDS_EPOCHS + 1), "--resume", "latest"])
        finally:
            clip_train.make_train_step = real_make
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = read_counts()
        ckpt_dir = run_dir / "checkpoints"
        epochs = ckpt.steps(str(ckpt_dir), ckpt.EPOCH)
        fetched = file_digest(ckpt_dir / "epoch_2.pt") == saved
        before, after = (torch.load(ckpt_dir / f"epoch_{n}.pt", map_location="cpu",
                                    weights_only=False, mmap=True) for n in (2, 3))
        adam_steps = sorted({(int(before["optimizer"]["state"][k]["step"]), int(v["step"]))
                             for k, v in after["optimizer"]["state"].items()})
        rows = [json_mod.loads(x) for x in (run_dir / "results.jsonl").read_text().splitlines()]
        zs_rows = [r for r in rows if "val/imagenet-zeroshot-val-top1" in r]
        final_mirror = all(tree(remote_dir).get(k) == v for k, v in tree(run_dir).items())
    step_ms = [r["ms"] for r in records]
    gaps = step_to_step_ms(records)
    steps_per_epoch = WDS_SHARDS * WDS_PER_SHARD // CLIP_CLI_B
    emit(phase="train_daclip_wds", what="cli.train_daclip.main over webdataset shards with "
         f"--force-patch-dropout {PATCH_DROPOUT}, zero-shot every epoch and --remote-sync "
         f"(fsspec): {WDS_EPOCHS} epochs, the local checkpoints deleted, then --resume latest "
         f"to {WDS_EPOCHS + 1} from the remote",
         config=dict(model=WDS_MODEL, precision="amp", B=CLIP_CLI_B, shards=WDS_SHARDS,
                     samples=WDS_SHARDS * WDS_PER_SHARD, sides=list(CLIP_SIDES),
                     png_rows="Up", zero_shot=dict(classes=WDS_ZS[0], per_class=WDS_ZS[1])),
         cuts=dict(batch=f"{CLIP_CLI_B}, not {DACLIP_B} (the host's PNG decode)",
                   data=f"{WDS_SHARDS} shards of {WDS_PER_SHARD}"),
         setup_s=setup_s, train_s=train_s, first=first, second=second,
         steps_run=[r["step"] for r in records], ms_per_step=step_ms,
         median_ms_per_step=float(np.median(step_ms)),
         median_ms_step_to_step=float(np.median(gaps)),
         samples_per_s_step_to_step=CLIP_CLI_B * 1e3 / float(np.median(gaps)),
         loader_samples_per_s_alone=loader_sps, tag_cache_hit=loaded, checkpoints=epochs,
         fetched_from_remote=fetched, adam_steps=adam_steps, zero_shot_rows=zs_rows,
         remote_mirrors_local=mirrored, remote_holds_final=final_mirror, launches=counts)
    check(loaded, "the seeded tag's weights did not load through the cache")
    check(epochs == [1, 2, 3] and fetched, f"checkpoints {epochs}, fetched {fetched}")
    check(len(records) == (WDS_EPOCHS + 1) * steps_per_epoch
          and records[n_first]["step"] == WDS_EPOCHS * steps_per_epoch
          and after["step"] == (WDS_EPOCHS + 1) * steps_per_epoch,
          f"train_daclip_wds ran steps {[r['step'] for r in records]}")
    check(adam_steps == [(WDS_EPOCHS * steps_per_epoch, (WDS_EPOCHS + 1) * steps_per_epoch)],
          f"AdamW's step counts before/after the resume: {adam_steps}")
    check(len(zs_rows) == WDS_EPOCHS + 1 and all(
        set(r) == {"step", "val/imagenet-zeroshot-val-top1", "val/imagenet-zeroshot-val-top5"}
        and 0 <= r["val/imagenet-zeroshot-val-top1"] <= 1 for r in zs_rows),
        f"zero-shot rows {zs_rows}")
    check(mirrored and final_mirror, "the remote does not mirror the log dir")
    check(np.isfinite([first["best_loss"], second["best_loss"]]).all(),
          "train_daclip_wds: a train loss is not finite")
    check(not any(counts.values()), f"train_daclip_wds launched hand kernels: {counts}")


# -- phase 14 ------------------------------------------------------------------
EVAL_CLASSES = ["blur05", "noisy25", "jpeg30", "resize10"]
# the eval CLIs batch within each class, so a class holds EVAL_B images:
# every batch is full
EVAL_PER_CLASS, EVAL_SIDES, EVAL_B = 32, (224, 288), 32
EVAL_NORM_TOL = 2e-2       # bf16 features' unit norm (tests/test_eval.py's tolerance)
EVAL_F32_LIMIT = 1e-4      # f32 features on the card vs the CPU, of their max


def daclip_jax_tree(cfg, seed, predictor=True):
    """A DaCLIP's parameter tree in daclip_tpu's layout (what its
    `save_params_npz` writes and `convert.daclip_state_dict_from_jax`
    reads; the transformer blocks stacked along a first axis), with the
    level predictor, filled from a numpy seed: fan-in scaled kernels and
    embeddings, LayerNorm scales near 1, small biases, no zero tensor."""
    rng = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    w = lambda *s, fan=None: f32(rng.randn(*s) * (fan or s[-2]) ** -0.5)
    b = lambda *s: f32(0.02 * rng.randn(*s))
    ln = lambda *s: {"scale": f32(1 + 0.1 * rng.randn(*s)), "bias": b(*s)}

    def blocks(L, d, hidden, zero=False):
        out = {"ln_1": ln(L, d), "ln_2": ln(L, d),
               "attn": {"in_proj": {"kernel": w(L, d, 3 * d), "bias": b(L, 3 * d)},
                        "out_proj": {"kernel": w(L, d, d), "bias": b(L, d)}},
               "mlp": {"c_fc": {"kernel": w(L, d, hidden), "bias": b(L, hidden)},
                       "c_proj": {"kernel": w(L, hidden, d), "bias": b(L, d)}}}
        if zero:
            out["zero_module"] = {"kernel": w(L, d, d), "bias": b(L, d)}
        return out

    v, t = cfg.vision, cfg.text
    grid = (v.image_size // v.patch_size) ** 2 + 1

    def visual(zero):
        return {"conv1": w(v.patch_size ** 2 * 3, v.width), "class_embedding": w(v.width, fan=v.width),
                "positional_embedding": w(grid, v.width, fan=v.width),
                "ln_pre": ln(v.width), "ln_post": ln(v.width), "proj": w(v.width, cfg.embed_dim),
                "transformer": {"resblocks": blocks(v.layers, v.width,
                                                    int(v.width * v.mlp_ratio), zero)}}

    scale = f32(np.log(1 / 0.07))
    tree = {"clip": {"visual": visual(False),
                     "text": {"token_embedding": f32(0.02 * rng.randn(t.vocab_size, t.width)),
                              "positional_embedding": f32(0.01 * rng.randn(t.context_length,
                                                                           t.width)),
                              "ln_final": ln(t.width), "text_projection": w(t.width, cfg.embed_dim),
                              "transformer": {"resblocks": blocks(t.layers, t.width,
                                                                  int(t.width * t.mlp_ratio))}},
                     "logit_scale": scale},
            "visual_control": visual(True), "logit_scale": scale}
    if predictor:
        tree["predictor"] = {"reg_w1": w(4, 7, 14), "reg_b1": b(4, 14),
                             "reg_w2": w(4, 14, 7), "reg_b2": b(4, 7)}
    return tree


def write_class_tree(root, classes, per_class, sides, seed, layout="LQ"):
    """`root/<class>/LQ/<i>.png` (`layout="LQ"`) or `root/<class>/<i>.png`
    (a class "" and no layout: a flat folder `root/<i>.png`):
    seeded images with sides drawn from `sides`, a class-dependent level of
    noise on a smooth scene, every row Up-filtered (PERF.md §5: the port's
    Paeth unfilter would set the phase's time)."""
    from daclip_torch.data import png

    rng = np.random.RandomState(seed)
    for ci, c in enumerate(classes):
        d = root / c / layout
        d.mkdir(parents=True)
        for i in range(per_class):
            h, w = rng.randint(sides[0], sides[1] + 1, 2)
            yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
            scene = 0.5 + 0.4 * np.sin(6 * np.stack([yy, xx, yy + xx], -1) + rng.rand(3))
            img = np.clip(scene + (0.05 + 0.1 * ci) * rng.randn(h, w, 3), 0, 1)
            png.write(str(d / f"{i:03d}.png"), (img * 255).round().astype(np.uint8), "up")


def optional_packages():
    """Whether matplotlib, sklearn, scipy, gradio, fsspec and transformers
    import here, with versions: the eval plots and tools/visualize need the
    first three, serve/gradio_app gradio, --remote-sync's fsspec protocol
    fsspec, and the hf_text phase transformers."""
    import importlib

    out = {}
    for name in ("matplotlib", "sklearn", "scipy", "gradio", "fsspec", "transformers"):
        try:
            out[name] = importlib.import_module(name).__version__
        except ImportError:
            out[name] = None
    return out


class _Timed:
    """Host seconds spent in `owner.name` while installed, and its calls."""

    def __init__(self, owner, name):
        self.owner, self.name, self.real = owner, name, getattr(owner, name)
        self.seconds, self.calls = 0.0, 0

    def __enter__(self):
        real = self.real

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = real(*args, **kw)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out

        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.real)


def _unit_norm_err(a):
    return float(np.abs(np.linalg.norm(a, axis=-1) - 1).max())


def run_eval(train_dir_inspect, model_name=DACLIP_MODEL, device="cuda", per_class=EVAL_PER_CLASS,
             sides=EVAL_SIDES, batch=EVAL_B):
    """The eval CLIs and tools at full width: a seeded daclip_ViT-B-32 with
    the level predictor, saved as a port .pt and as a daclip_tpu .npz, over
    a seeded 4-class tree of Up-filtered PNGs. evaluate_daclip with both
    checkpoints (so compare_checkpoints runs), evaluate_numclip at
    `batch`, imagenet_zero_shot.evaluate on a 3-class tree (the 80
    templates), encode_folder on both layouts, inspect_checkpoint on the
    .pt, the .npz and `train_dir_inspect` (train_daclip_cli's train dir,
    inspected there); then the f32 features of 4 images on the card
    against the CPU's. No hand kernel may launch."""
    import tempfile

    from daclip_torch.convert import daclip_state_dict_from_jax
    from daclip_torch.eval import DaclipEncoders
    from daclip_torch.eval import evaluate_daclip as ev_daclip
    from daclip_torch.eval import evaluate_numclip as ev_numclip
    from daclip_torch.eval import imagenet_zero_shot as zs
    from daclip_torch.models.clip import CLIPCfg, get_model_config
    from daclip_torch.tools import encode_folder as enc
    from daclip_torch.tools import inspect_checkpoint as insp
    from daclip_torch.utils.native_checkpoint import save_params_npz

    have = optional_packages()
    cfg = CLIPCfg.from_dict(get_model_config(model_name))
    n_img = len(EVAL_CLASSES) * per_class
    out = {}
    with tempfile.TemporaryDirectory() as d:
        root = pathlib.Path(d)
        t0 = time.perf_counter()
        tree = daclip_jax_tree(cfg, seed=51)
        pt, npz = root / "daclip.pt", root / "daclip.npz"
        torch.save(daclip_state_dict_from_jax(tree), pt)
        save_params_npz(str(npz), tree)
        del tree
        write_class_tree(root / "tree", EVAL_CLASSES, per_class, sides, seed=52)
        write_class_tree(root / "zs", EVAL_CLASSES[:3], 4, sides, seed=53, layout="")
        write_class_tree(root / "flat", [""], 8, sides, seed=54, layout="")
        out["setup_s"] = time.perf_counter() - t0
        reset_counts()

        # evaluate_daclip over both checkpoints
        t0 = time.perf_counter()
        res = ev_daclip.main(["--dataset", str(root / "tree"), "--checkpoint", f"pt={pt}",
                              "--checkpoint", f"npz={npz}", "--model", model_name,
                              "--batch-size", str(batch), "--out-dir", str(root / "daclip"),
                              "--device", device])
        s = time.perf_counter() - t0
        files = sorted(os.listdir(root / "daclip"))
        same = all((root / "daclip" / f"{kind}_pt.csv").read_text()
                   == (root / "daclip" / f"{kind}_npz.csv").read_text()
                   for kind in ("per_class_accuracy", "confusion_matrix"))
        pngs = [f for f in files if f.endswith(".png")]
        out["evaluate_daclip"] = dict(
            images=2 * n_img, seconds=s, images_per_s=2 * n_img / s,
            accuracy={k: r["accuracy"] for k, r in res.items()},
            base_accuracy={k: r["base_accuracy"] for k, r in res.items()},
            pt_equals_npz=same, files=files, pngs_written=pngs)
        check(same and res["pt"] == res["npz"],
              "evaluate_daclip: the .pt and the .npz gave different predictions")
        check(all(0 <= r[k] <= 1 for r in res.values() for k in ("accuracy", "base_accuracy")),
              f"evaluate_daclip accuracies {out['evaluate_daclip']['accuracy']}")
        want = {f"{kind}_{k}.csv" for k in ("pt", "npz")
                for kind in ("per_class_accuracy", "confusion_matrix")}
        check(want <= set(files), f"evaluate_daclip wrote {files}")
        plots = {"confusion_matrix_pt.png", "confusion_matrix_npz.png",
                 "base_class_accuracy_table.png", "compare_base_class_accuracy.png",
                 "compare_full_class_accuracy.png"}
        if have["matplotlib"]:
            check(plots <= set(files), f"evaluate_daclip's plots: {pngs}")
        else:
            check(not pngs and ev_daclip.compare_checkpoints(res, str(root / "daclip"))
                  == [False] * 3, "without matplotlib the plots must return False")

        # evaluate_numclip at B = batch, the image loop timed by hooks
        t0 = time.perf_counter()
        with _Timed(ev_numclip, "read_views") as host, _Timed(DaclipEncoders, "image") as dev:
            res = ev_numclip.main(["--dataset", str(root / "tree"), "--checkpoint", f"pt={pt}",
                                   "--model", model_name, "--batch-size", str(batch),
                                   "--out-dir", str(root / "numclip"), "--device", device])["pt"]
        s = time.perf_counter() - t0
        emb = np.load(root / "numclip" / "embeddings" / "all_embeddings.npy")
        files = sorted(os.listdir(root / "numclip"))
        loop = host.seconds + dev.seconds
        out["evaluate_numclip"] = dict(
            images=n_img, batch=batch, seconds=s, images_per_s_cli=n_img / s,
            images_per_s=n_img / loop, host_ms_per_image=host.seconds / n_img * 1e3,
            encode_ms_per_batch=dev.seconds / dev.calls * 1e3, batches=dev.calls,
            accuracy=res["accuracy"], base_accuracy=res["base_accuracy"],
            regression_mae=res["regression_mae"], unit_norm_err=_unit_norm_err(emb),
            files=files)
        check(dev.calls == n_img // batch,
              f"numclip encoded {dev.calls} batches, not {n_img // batch} of {batch}")
        check(emb.shape == (n_img, cfg.embed_dim), f"numclip embeddings {emb.shape}")
        check(_unit_norm_err(emb) <= EVAL_NORM_TOL, "numclip embeddings are not unit-norm")
        check(set(res["regression_mae"]) == {"blur", "noisy", "resize", "jpeg"}
              and np.isfinite(list(res["regression_mae"].values())).all(),
              f"numclip regression MAE {res['regression_mae']}")
        check(0 <= res["accuracy"] <= 1 and 0 <= res["base_accuracy"] <= 1, "numclip accuracy")
        check({"predictions_pt.csv", "regression_values_pt.csv", "confusion_matrix_pt.csv",
               "embeddings"} <= set(files), f"evaluate_numclip wrote {files}")
        check(("confusion_matrix_pt.png" in files) == bool(have["matplotlib"]),
              "numclip's confusion PNG")

        # ImageNet-style zero-shot: 3 classes × the 80 templates
        t0 = time.perf_counter()
        zres = zs.evaluate(str(pt), str(root / "zs"), model_name, device=device)
        out["imagenet_zero_shot"] = dict(zres, classes=3, prompts=3 * 80, images=12,
                                         seconds=time.perf_counter() - t0)
        check(all(0 <= v <= 1 for v in zres.values()), f"zero-shot {zres}")

        # encode_folder: the class tree (labels = classes) and a flat folder
        for name, src, n, feats in (("tree", root / "tree", n_img, "degra"),
                                    ("flat", root / "flat", 8, "image")):
            t0 = time.perf_counter()
            got = enc.main(["--input", str(src), "--checkpoint", str(npz), "--model", model_name,
                            "--out", str(root / f"enc_{name}"), "--batch-size", str(batch),
                            "--features", feats, "--device", device])
            s = time.perf_counter() - t0
            dumps = {f: np.load(root / f"enc_{name}" / f) for f in
                     ("all_embeddings.npy", "degra_embeddings.npy", "image_embeddings.npy",
                      "labels.npy", "filenames.npy")}
            labels = list(dumps["labels.npy"])
            out[f"encode_folder_{name}"] = dict(
                images=got, seconds=s, images_per_s=got / s, features=feats,
                unit_norm_err=max(_unit_norm_err(dumps[f]) for f in
                                  ("degra_embeddings.npy", "image_embeddings.npy")))
            check(got == n and len(labels) == n, f"encode_folder {name}: {got} images")
            check(out[f"encode_folder_{name}"]["unit_norm_err"] <= EVAL_NORM_TOL,
                  f"encode_folder {name}: features not unit-norm")
            want = ([c for c in sorted(EVAL_CLASSES) for _ in range(per_class)] if name == "tree"
                    else [f"{i:03d}" for i in range(8)])
            check(labels == want, f"encode_folder {name} labels")

        # inspect_checkpoint
        lines = []
        out["inspect_checkpoint"] = {
            k: dict(insp.describe(*insp.load_tree(str(p)), limit=3, _print=lines.append))
            for k, p in (("pt", pt), ("npz", npz))}
        out["inspect_checkpoint"]["train_daclip_cli_dir"] = train_dir_inspect
        check(all(v["leaves"] > 0 for v in out["inspect_checkpoint"].values()),
              "inspect_checkpoint found no leaves")

        # f32 features of 4 images: the card against the CPU
        feats = {}
        for dev_name in (device, "cpu"):
            enc.encode_folder(str(pt), str(root / "flat"), str(root / f"f32_{dev_name}"),
                              model_name, batch_size=4, device=dev_name, dtype=torch.float32)
            feats[dev_name] = {f: np.load(root / f"f32_{dev_name}" / f"{f}_embeddings.npy")[:4]
                               for f in ("degra", "image")}
        errs = {f: float(np.abs(feats[device][f] - feats["cpu"][f]).max()
                         / np.abs(feats["cpu"][f]).max()) for f in ("degra", "image")}
        out["f32_card_vs_cpu_of_max"] = errs
        counts = read_counts()
    emit(phase="eval", model=model_name, classes=EVAL_CLASSES, per_class=per_class,
         sides=list(sides), png_rows="Up", optional_packages=have, launches=counts, **out)
    check(all(e <= EVAL_F32_LIMIT for e in errs.values()),
          f"eval: f32 features on the card vs the CPU {errs}")
    check(not any(counts.values()), f"the eval CLIs launched hand kernels: {counts}")


# -- phase 15 ------------------------------------------------------------------
LPIPS_B, LPIPS_SIZE = 4, 256
LPIPS_LIMIT = 1e-5          # f32, the card against the CPU, relative
LPIPS_CONVS = [(3, 64, 11), (64, 192, 5), (192, 384, 3), (384, 256, 3), (256, 256, 3)]


def write_lpips_npz(path, seed=61):
    """Seeded AlexNet-shaped LPIPS weights in daclip_tpu's layout (HWIO convs,
    (1, 1, C, 1) non-negative heads)."""
    rng = np.random.RandomState(seed)
    w = {}
    for i, (cin, cout, k) in enumerate(LPIPS_CONVS):
        w[f"conv{i}_w"] = (rng.randn(k, k, cin, cout) / np.sqrt(k * k * cin)).astype(np.float32)
        w[f"conv{i}_b"] = (0.05 * rng.randn(cout)).astype(np.float32)
        w[f"lin{i}_w"] = np.abs(rng.randn(1, 1, cout, 1)).astype(np.float32)
    np.savez(path, **w)
    return str(path)


def run_lpips(weights, device="cuda", B=LPIPS_B, size=LPIPS_SIZE):
    """LPIPS(alex) on the card against the same on the CPU, f32, B pairs at
    size², and its ms a pair."""
    from daclip_torch.utils.lpips import LPIPS

    rng = np.random.RandomState(62)
    a = rng.uniform(-1, 1, (B, size, size, 3)).astype(np.float32)
    b = np.clip(a + 0.3 * rng.randn(*a.shape), -1, 1).astype(np.float32)
    card, cpu = LPIPS.from_npz(weights, device=device), LPIPS.from_npz(weights, device="cpu")
    got, want = card(a, b), cpu(a, b)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    ta, tb = (torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(device) for x in (a, b))
    with torch.no_grad():
        ms_b = time_ms(lambda: card.distance(ta, tb), iters=10)
        ms_1 = time_ms(lambda: card.distance(ta[:1], tb[:1]), iters=10)
    emit(phase="lpips", shape=[B, size, size, 3], dtype="float32", lpips=got.tolist(),
         rel_err_card_vs_cpu=rel, limit=LPIPS_LIMIT, ms_batch=ms_b, ms_per_pair=ms_b / B,
         ms_one_pair=ms_1)
    check(np.isfinite(got).all() and (got > 0).all(), f"LPIPS values {got}")
    check(rel <= LPIPS_LIMIT, f"LPIPS: the card vs the CPU {rel}")


# -- phase 16 ------------------------------------------------------------------
STAGE_ARGV = ["--batch", "4", "--size", "256"]
STAGE_CALLS = 31            # a row: one warm-up call and 30 timed ones


def run_stage_profile():
    """utils/stage_profile at B=4, 256², bf16 on the card (the linear wraps
    launch #1, the level-3 self-attention #2), then utils/profile for
    daclip_ViT-B-32 and the 256² UNet. Its counts are taken on fake CPU
    tensors whatever the device (equal to the CPU's by construction), so
    they are held against FlopCounterMode over real forwards on the card:
    encode_image(control=True), which runs no hand kernel, must count the
    same; the UNet's count must exceed what the counter sees on the card,
    where #1 and #2 are ctypes launches it cannot see. Returns the
    stage_profile launches."""
    from torch.utils.flop_counter import FlopCounterMode

    from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config
    from daclip_torch.models.unet import ConditionalUNet
    from daclip_torch.utils import profile, stage_profile

    reset_counts()
    rows = stage_profile.main(STAGE_ARGV + ["--device", "cuda"])
    counts = {k: v for k, v in read_counts().items() if v}
    want = {"wrap": 3 * STAGE_CALLS, "flash": STAGE_CALLS}
    emit(phase="stage_profile", argv=STAGE_ARGV, dtype="bfloat16", rows_ms=rows,
         launches=counts, want_launches=want)
    check(len(rows) == 11 and all(np.isfinite(v) and v > 0 for v in rows.values()),
          f"stage_profile rows {rows}")
    check(counts == want, f"stage_profile launches {counts}, expected {want}")

    t0 = time.perf_counter()
    prof = profile.main(["--model", DACLIP_MODEL, "--unet-size", "256", "--device", "cuda"])
    prof_s = time.perf_counter() - t0

    def card_gflops(fn, *args):
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            fn(*args)
        torch.cuda.synchronize()
        return counter.get_total_flops() / 1e9

    gen = torch.Generator("cuda").manual_seed(71)
    with torch.device("cuda"):
        m = DaCLIP(CLIPCfg.from_dict(get_model_config(DACLIP_MODEL)), dtype=torch.bfloat16).eval()
        img = torch.randn(1, 3, 224, 224, generator=gen)
        net = ConditionalUNet(nf=64, ch_mult=(1, 2, 4, 8), context_dim=512,
                              use_degra_context=True, use_image_context=True,
                              dtype=torch.bfloat16).eval()
        x = torch.randn(1, 3, 256, 256, generator=gen)
        ctx = torch.randn(1, 512, generator=gen)
    # what encode_image(control=True) achieves on the card at B=1, bf16
    with torch.no_grad():
        img_ms = profile.wallclock_ms(lambda t: m.encode_image(t, control=True), img, iters=20)
    g_img = prof["clip"]["encode_image_control"]["gflops"]
    g_unet = prof["unet"]["forward"]["gflops"]
    seen = {"encode_image_control": card_gflops(lambda t: m.encode_image(t, control=True), img),
            "unet_forward": card_gflops(lambda t: net(t, x, torch.ones(1, device="cuda"), ctx,
                                                      ctx), x)}
    emit(phase="stage_profile", what="utils.profile, and FlopCounterMode on the card",
         model=DACLIP_MODEL, unet_size=256,
         profile=json.loads(json.dumps(prof, default=float).replace("NaN", "null")),
         seconds=prof_s, card_counter_gflops=seen,
         unet_gflops_unseen_on_card=g_unet - seen["unet_forward"],
         encode_image_control_ms=img_ms, encode_image_control_tflops=g_img / img_ms)
    check(seen["encode_image_control"] == g_img,
          f"profile: encode_image(control) {g_img} GFLOP, the card's counter "
          f"{seen['encode_image_control']}")
    check(0 < seen["unet_forward"] < g_unet,
          f"profile: the UNet's {g_unet} GFLOP against {seen['unet_forward']} seen on the card")
    return counts


# -- phases 17-21: the port's multi-card paths on the one card ---------------
DDP_STEPS = 3
# an f32 DA-CLIP step through DDP against the same step without it (read: 0
# at one rank, 1.8e-7 at two ranks on one card), each parameter's
# difference over the largest |parameter|
DDP_F32_LIMIT = 1e-6
# fsdp_train against the single process: per-block FSDP2 puts its hooks'
# autograd nodes between the blocks, so the gradients of inputs several
# blocks share (the time embedding, the skips) are summed in another order;
# the first loss must still be bitwise equal, the later losses and every
# step's gradient norm within this relative difference
FSDP_TRAIN_RTOL = 1e-3


@contextlib.contextmanager
def world_of_one():
    """torchrun's environment for one process (MASTER_ADDR localhost, a free
    port, RANK 0, WORLD_SIZE 1, LOCAL_RANK 0), the NCCL group formed by
    `daclip_torch.parallel.initialize_distributed` as the CLIs form it, and
    torchrun's one-process `Mesh`; the group destroyed and the environment
    restored after."""
    import socket

    from daclip_torch import parallel

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0", WORLD_SIZE="1",
               LOCAL_RANK="0")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        got = parallel.initialize_distributed()
        check(got == (0, 1, 0, torch.device("cuda", 0)), f"initialize_distributed: {got}")
        check(torch.distributed.get_backend() == "nccl",
              f"backend {torch.distributed.get_backend()}")
        yield parallel.mesh_from_spec("1", 1, "cuda")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_ddp_train(mesh, train_step_ms):
    """`train`'s production step (B=16, 256², nf 64, ch_mult 1,2,4,8, v5,
    bf16, remat, AdamW, EMA) for DDP_STEPS steps from the same seeded UNet
    on the same batch, contexts and (t, noise) draws: twice in one process
    (the second a control of the card's determinism), through DDP
    (`parallel.parallelize` on torchrun's one-process mesh, NCCL, DDP's
    static graph) and through FSDP2 (`parallel.apply_fsdp`, fully_shard at
    one rank, one unit per ResBlock and attention wrap). cuDNN
    picks deterministic algorithms here. Each run's step ms, peak memory
    and launches of #1-#4 (paths `ddp_train`, `fsdp_train`); the DDP run's
    parameters must equal the single process's bit for bit (an average over
    one rank is exact). The FSDP run's first loss must too, and its later
    losses and gradient norms within FSDP_TRAIN_RTOL (FSDP's units reorder
    the sums of shared inputs' gradients), its parameters within Adam's
    bound 2·Σ lr of the single process's; its optimizer groups keep shards
    and whole tensors apart, so its AdamW takes torch's foreach path too."""
    import gc

    from daclip_torch import parallel
    from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config
    from daclip_torch.models.unet import ConditionalUNet
    from daclip_torch.sde import IRSDE
    from daclip_torch.train.restoration import (RestorationTrainConfig, init_state,
                                                make_schedule, make_train_step)
    from daclip_torch.transforms import clip_transform

    gc.collect()
    torch.cuda.empty_cache()
    B, P = 16, 256
    kw = dict(nf=64, ch_mult=(1, 2, 4, 8), context_dim=512, use_degra_context=True,
              use_image_context=True)
    sd = seeded_state_dict(lambda: ConditionalUNet(**kw), seed=11)
    clip_cfg = CLIPCfg.from_dict(get_model_config("daclip_ViT-B-32"))
    daclip = DaCLIP(clip_cfg, dtype=torch.bfloat16)
    daclip.load_state_dict(seeded_state_dict(lambda: DaCLIP(clip_cfg), seed=12), strict=True)
    daclip.cuda().eval().requires_grad_(False)
    rng = np.random.RandomState(0)
    gt_np = rng.rand(B, P, P, 3).astype(np.float32)
    lq_np = np.clip(gt_np + 0.1 * rng.randn(B, P, P, 3), 0, 1).astype(np.float32)
    views_np = np.stack([clip_transform(im, clip_cfg.vision.image_size) for im in lq_np])
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).cuda()
    with torch.no_grad():
        img_f, degra_f = daclip.encode_image(dev(views_np), control=True, normalize=True)
    batch = dict(LQ=dev(lq_np), GT=dev(gt_np), text_context=degra_f.float(),
                 image_context=img_f.float())
    del daclip
    sde = IRSDE(max_sigma=50, T=100, schedule="cosine", eps=0.005)
    cfg = RestorationTrainConfig()
    want_calls = {k: DDP_STEPS * v for k, v in zip(TRAIN_KERNELS["v5"], (12, 6, 6, 3))}

    def trained(kind):
        unet = ConditionalUNet(dtype=torch.bfloat16, remat=True, **kw)
        unet.load_state_dict(sd)
        unet.train().cuda()
        wrapped = {"ddp": lambda: parallel.parallelize(unet, mesh, "cuda", static_graph=True),
                   "fsdp": lambda: parallel.apply_fsdp(unet, mesh)}.get(kind, lambda: unet)()
        state = init_state(unet, cfg, device="cuda")
        step = make_train_step(wrapped, sde, cfg, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        ms, losses, norms = [], [], []
        for _ in range(DDP_STEPS):
            t0 = time.perf_counter()
            _, m = step(state, batch, gen)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        counts = {k: v for k, v in read_counts().items() if v}
        params = parallel.full_tensors(dict(unet.named_parameters()))
        # the first step holds cuDNN's and the allocator's warm-up
        row = dict(ms_per_step=ms, median_ms_after_first=float(np.median(ms[1:])), losses=losses,
                   grad_norms=norms, max_memory_allocated=torch.cuda.max_memory_allocated(), calls=counts,
                   sharded=sum(type(p).__name__ == "DTensor" for p in unet.parameters()),
                   wrapper=type(wrapped).__name__)
        del unet, wrapped, state, step
        gc.collect()
        torch.cuda.empty_cache()
        return params, row

    deterministic = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        runs = {kind: trained(kind) for kind in ("train", "control", "ddp", "fsdp")}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
    ref = runs["train"][0]
    p_max = max(float(v.abs().max()) for v in ref.values())

    def diff(kind):
        d = {k: float((runs[kind][0][k] - v).abs().max()) for k, v in ref.items()}
        worst = max(d, key=d.get)
        return dict(max_abs_diff=d[worst], worst=worst, of_max=d[worst] / p_max,
                    tensors_differing=sum(x > 0 for x in d.values()),
                    bitwise=all(torch.equal(runs[kind][0][k], v) for k, v in ref.items()))

    out = {}
    for kind, phase in (("ddp", "ddp_train"), ("fsdp", "fsdp_train")):
        row = runs[kind][1]
        emit(phase=phase, what=f"train's step through {row['wrapper']} at world size 1 (NCCL), "
             f"{DDP_STEPS} steps from the seeded UNet, against the single-process trainer on "
             "the same draws (cuDNN deterministic)",
             config=dict(B=B, patch=P, remat=True, dtype="bfloat16", wiring="v5", **kw),
             **row, single_process=runs["train"][1], control=diff("control"),
             vs_single_process=diff(kind), train_phase_median_ms=train_step_ms,
             params_max=p_max)
        check(row["calls"] == want_calls, f"{phase}: kernel calls {row['calls']}, expected "
              f"{want_calls}")
        check(np.isfinite(row["losses"]).all(), f"{phase}: a loss is not finite")
        out[kind] = row["calls"]
    check(runs["fsdp"][1]["sharded"] > 0, "fsdp_train: no parameter is an FSDP shard")
    check(diff("ddp")["bitwise"], f"ddp_train: parameters differ from the single "
          f"process ({diff('ddp')}; control {diff('control')})")
    fsdp, one = runs["fsdp"][1], runs["train"][1]
    check(fsdp["losses"][0] == one["losses"][0],
          f"fsdp_train: first loss {fsdp['losses'][0]} against {one['losses'][0]}")
    for key in ("losses", "grad_norms"):
        check(np.allclose(fsdp[key], one[key], rtol=FSDP_TRAIN_RTOL, atol=0),
              f"fsdp_train: {key} {fsdp[key]} against the single process's {one[key]}")
    adam_bound = 2 * sum(make_schedule(cfg)(i) for i in range(DDP_STEPS))
    check(diff("fsdp")["max_abs_diff"] <= adam_bound,
          f"fsdp_train: parameters {diff('fsdp')} past Adam's bound {adam_bound}")
    return out["ddp"], out["fsdp"]


def run_ddp_daclip(mesh, base, steps=3, warmup=1):
    """train_daclip's step (README's launch line: daclip_ViT-B-32 with the
    predictor, bf16, B = 512 at 224²) through DDP and the gathered losses
    on torchrun's one-process mesh: step ms, samples/s and peak memory
    beside train_daclip's (`base`); then an f32 step at B = DACLIP_F32_B on
    the card through DDP against the same step without it (DDP_F32_LIMIT of
    the largest |parameter|); no hand kernel launched."""
    import gc

    from daclip_torch import parallel
    from daclip_torch.train.clip_train import (init_state, make_train_step,
                                               partition_daclip_params)

    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()

    def make(dtype_name, cfg, ddp):
        model = daclip_model(dtype_name, "cuda", base["sd"])
        partition_daclip_params(model)
        wrapped = parallel.parallelize(model, mesh, "cuda") if ddp else model
        state = init_state(model, cfg, device="cuda")
        return model, state, make_train_step(wrapped, cfg, base["banks"], device="cuda")

    model, state, step = make("amp", base["cfg"], True)
    batch = clip_batch(DACLIP_B, seed=32, device="cuda", **base["shape"])
    for _ in range(warmup):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, metrics = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        _, m = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()
    step_ms = float(np.median(ms))
    del model, state, step, batch
    gc.collect()
    torch.cuda.empty_cache()

    f32 = dataclasses.replace(base["cfg"], lr=1e-3, eps=1e-3, warmup=1)
    small = clip_batch(DACLIP_F32_B, seed=33, device="cuda", **base["shape"])
    after = {}
    for ddp in (False, True):
        model, state, step = make("fp32", f32, ddp)
        step(state, small)
        after[ddp] = {n: p.detach().clone() for n, p in state.params}
        del model, state, step
    p_max = max(float(p.abs().max()) for p in after[False].values())
    err = {n: float((after[True][n] - p).abs().max()) for n, p in after[False].items()}
    worst = max(err, key=err.get)
    emit(phase="ddp_daclip", what=f"train_daclip's step through DDP at world size 1 (NCCL, "
         f"the features all-gathered), {DACLIP_MODEL} with the predictor, bf16, B={DACLIP_B} "
         f"({warmup} warm-up, {steps} timed steps); then an f32 step at B={DACLIP_F32_B}, DDP "
         "against no DDP, on the card",
         ms_per_step=ms, median_ms_per_step=step_ms, samples_per_s=DACLIP_B * 1e3 / step_ms,
         max_memory_allocated=peak, metrics=metrics,
         train_daclip=dict(median_ms_per_step=base["step_ms"],
                           samples_per_s=base["samples_per_s"],
                           max_memory_allocated=base["peak"]),
         f32=dict(max_abs_diff=err[worst], worst=worst, params_max=p_max,
                  of_max=err[worst] / p_max, bitwise=all(v == 0 for v in err.values())),
         limit=DDP_F32_LIMIT)
    check(all(np.isfinite(list(m.values())).all() for m in metrics),
          "ddp_daclip: a loss term is not finite")
    check(err[worst] <= DDP_F32_LIMIT * p_max,
          f"ddp_daclip f32: DDP vs no DDP {err[worst]} ({worst}), max |p| {p_max}")
    counts = read_counts()
    check(not any(counts.values()), f"ddp_daclip launched hand kernels: {counts}")


TWO_RANK_B = 64   # the global batch of two_ranks_one_card, 32 rows a rank


def two_ranks_worker(rank, store, out):
    """One of two ranks on cuda:0, the group gloo's (NCCL refuses two ranks
    on one device), formed through `daclip_torch.parallel` from torchrun's
    variables: the f32 DA-CLIP step (lr 1e-3, eps 1e-3) through DDP on its
    32 rows of a seeded B = TWO_RANK_B batch; rank 0 then takes the same step
    in one process on all 64 rows and writes both parameter sets' largest
    difference to `out`."""
    import datetime

    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from daclip_torch import parallel
    from daclip_torch.data.csv_dataset import build_banks
    from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config
    from daclip_torch.tokenizer import tokenize
    from daclip_torch.train.clip_train import (ClipTrainConfig, init_state, make_train_step,
                                               partition_daclip_params)

    got = parallel.initialize_distributed(f"file://{store}", "gloo", "cuda",
                                          set_device_rank=False,
                                          timeout=datetime.timedelta(seconds=300))
    mesh = parallel.mesh_from_spec("2", 2, "cuda")
    clip_cfg = CLIPCfg.from_dict(get_model_config(DACLIP_MODEL))
    sd = seeded_state_dict(lambda: DaCLIP(clip_cfg, use_predictor=True), seed=31)
    banks = build_banks(partial(tokenize, context_length=clip_cfg.text.context_length))
    cfg = ClipTrainConfig(lr=1e-3, wd=0.2, beta1=0.9, beta2=0.98, eps=1e-3, warmup=1,
                          variant="fork")
    batch = clip_batch(TWO_RANK_B, seed=34, device="cpu", res=clip_cfg.vision.image_size,
                       L=clip_cfg.text.context_length)

    def stepped(wrap, rows):
        model = daclip_model("fp32", "cuda", sd)
        partition_daclip_params(model)
        wrapped = parallel.parallelize(model, mesh, "cuda") if wrap else model
        state = init_state(model, cfg, device="cuda")
        _, m = make_train_step(wrapped, cfg, banks, device="cuda")(
            state, {k: v[rows].cuda() for k, v in batch.items()})
        return float(m["total_loss"]), {n: p.detach().clone() for n, p in state.params}

    half = TWO_RANK_B // 2
    reset_counts()
    loss, ddp = stepped(True, slice(rank * half, (rank + 1) * half))
    counts = read_counts()
    if rank == 0:
        loss_one, one = stepped(False, slice(0, TWO_RANK_B))
        err = {n: float((ddp[n] - p).abs().max()) for n, p in one.items()}
        worst = max(err, key=err.get)
        p_max = max(float(p.abs().max()) for p in one.values())
        pathlib.Path(out).write_text(json.dumps(dict(
            initialized=[str(x) for x in got], backend=torch.distributed.get_backend(),
            loss_two_ranks=loss, loss_one_process=loss_one, max_abs_diff=err[worst],
            worst=worst, params_max=p_max, of_max=err[worst] / p_max, hand_kernels=counts)))
    parallel.barrier()
    torch.distributed.destroy_process_group()


def run_two_ranks_one_card():
    """Two ranks on the one card over gloo with CUDA tensors
    (`two_ranks_worker`): DDP with the all-gathered losses at world size 2,
    the f32 step against one process on the same 64 rows, within
    DDP_F32_LIMIT of the largest |parameter|; no hand kernel launched."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        out = pathlib.Path(d) / "out.json"
        procs = [ctx.Process(target=two_ranks_worker, args=(r, f"{d}/store", str(out)))
                 for r in range(2)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(600)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        check(codes == [0, 0], f"two_ranks_one_card: the ranks exited {codes}")
        row = json.loads(out.read_text())
    emit(phase="two_ranks_one_card", what=f"two processes on cuda:0 over gloo, DDP and the "
         f"gathered losses, an f32 step of {DACLIP_MODEL} on {TWO_RANK_B // 2} rows each, "
         f"against one process on all {TWO_RANK_B}", seconds=time.perf_counter() - t0,
         **row, limit=DDP_F32_LIMIT)
    check(row["backend"] == "gloo", f"two_ranks_one_card backend {row['backend']}")
    check(row["of_max"] <= DDP_F32_LIMIT, f"two_ranks_one_card: {row}")
    check(not any(row["hand_kernels"].values()), f"hand kernels: {row['hand_kernels']}")


def torchrun(module, args, cwd, timeout=900):
    """`python -m torch.distributed.run --standalone --nproc_per_node 1 -m
    <module> <args>` in `cwd` (the repository on PYTHONPATH), its output to
    `cwd/<module>.log`; the seconds it took and the log's tail. Fails on a
    non-zero exit. (torchrun's parser takes an abbreviation of its own
    options, so `--logs` would be its `--logs-specs`: the DA-CLIP CLI logs
    to its default ./logs under `cwd`.)"""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "1", "-m", module, *args]
    log = pathlib.Path(cwd) / f"{module}.log"
    t0 = time.perf_counter()
    with open(log, "w") as f:
        res = subprocess.run(cmd, cwd=cwd, env=env, stdout=f, stderr=subprocess.STDOUT,
                             timeout=timeout)
    seconds = time.perf_counter() - t0
    tail = log.read_text()[-3000:]
    check(res.returncode == 0, f"torchrun -m {module} exited {res.returncode}:\n{tail}")
    return seconds, tail


def file_listing(root):
    """Every file under `root`, relative to it, sorted; an orbax data file's
    random name (`d/<32 hex>`) as `d/*`."""
    return sorted(re.sub(r"/d/[0-9a-f]{32}$", "/d/*", str(p.relative_to(root)))
                  for p in root.rglob("*") if p.is_file())


def step_dir_files(step):
    """The files of one step dir that `orbax_writer` writes."""
    return [f"{step}/{f}" for f in ("_CHECKPOINT_METADATA", "default/_METADATA",
                                     "default/_sharding", "default/array_metadatas/process_0",
                                     "default/d/*", "default/manifest.ocdbt")]


def run_torchrun_cli():
    """Both train CLIs launched by torchrun (one process, `--mesh 1`, NCCL):
    `cli.train_daclip` for one epoch over train_daclip_cli's seeded CSV tree
    (--da, daclip_ViT-B-32, amp, batch 8, 4 workers), and
    `cli.train_restoration -opt` on train_cli's options and seeded MD tree
    for 2 steps (a validation and a checkpoint at 2), both trees' PNGs with
    Up rows only; each must write
    exactly its one checkpoint (no temporary file left), which loads into
    the single-card model."""
    import gc
    import tempfile

    import yaml

    from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config
    from daclip_torch.models.unet import ConditionalUNet
    from daclip_torch.utils.checkpoint import load_params

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        root = pathlib.Path(d)
        # the same seeded pixels as train_daclip_cli's and train_cli's trees,
        # every PNG with Up rows: the Paeth decode (~1 s an image, the host's
        # GIL) is those phases' to measure, and would double this one's time
        train_csv = write_clip_tree(root / "clip", CLIP_TREE[0], seed=41, filters=("up",))
        daclip_s, daclip_log = torchrun("daclip_torch.cli.train_daclip", [
            "--mesh", "1", "--train-data", train_csv, "--da", "--model", DACLIP_MODEL,
            "--precision", "amp", "--batch-size", str(CLIP_CLI_B), "--workers",
            str(CLIP_CLI_WORKERS), "--name", "run", "--lr", "2e-5", "--epochs", "1"], root)
        ckpts = root / "logs" / "run" / "checkpoints"
        files = file_listing(ckpts)
        want = sorted(f"{sub}{f}" for sub in ("", "best/")
                      for f in ["epoch_1.pt"] + step_dir_files(1))
        check(files == want, f"torchrun train_daclip wrote {files}")
        clip_cfg = CLIPCfg.from_dict(get_model_config(DACLIP_MODEL))
        ck = torch.load(ckpts / "epoch_1.pt", map_location="cpu", weights_only=False)
        DaCLIP(clip_cfg, use_predictor=True).load_state_dict(ck["state_dict"], strict=True)
        clip_steps = int(ck["step"])

        types = ["noisy", "rainy"]
        write_md_tree(root / "train", types, 8, CLI_MD_SHAPE, seed=21, filters=("up",))
        write_md_tree(root / "val", types, 1, CLI_VAL_SHAPE, seed=22, filters=("up",))
        daclip_pt = root / "daclip_ViT-B-32.pt"
        torch.save({k: v.cpu() for k, v in seeded_state_dict(lambda: DaCLIP(clip_cfg),
                                                             seed=12).items()}, daclip_pt)
        opt = yaml.safe_load((REPO / "configs" / "daclip-sde" / "train.yml").read_text())
        opt["distortion"] = types
        opt["datasets"]["train"]["dataroot"] = str(root / "train")
        opt["datasets"]["val"]["dataroot"] = str(root / "val")
        opt["path"].update(root=str(root / "out"), daclip=str(daclip_pt))
        opt["train"].update(niter=2, val_freq=2)
        opt["logger"].update(print_freq=1, save_checkpoint_freq=2)
        train_yml = root / "train.yml"
        train_yml.write_text(yaml.safe_dump(opt))
        resto_s, resto_log = torchrun("daclip_torch.cli.train_restoration", [
            "-opt", str(train_yml), "--mesh", "1", "--val-sample-T", str(CLI_VAL_T)], root)
        state_dir = root / "out" / "experiments" / opt["name"] / "training_state"
        resto_files = file_listing(state_dir)
        check(resto_files == sorted(["2.pt"] + step_dir_files(2)),
              f"torchrun train_restoration wrote {resto_files}")
        net_opt = opt["network_G"]["setting"]
        unet = ConditionalUNet(nf=net_opt["nf"], ch_mult=tuple(net_opt["ch_mult"]),
                               context_dim=net_opt["context_dim"],
                               use_degra_context=net_opt["use_degra_context"],
                               use_image_context=net_opt["use_image_context"])
        unet.load_state_dict(load_params(str(state_dir)), strict=True)
        resto_step = int(torch.load(state_dir / "2.pt", map_location="cpu",
                                    weights_only=False)["step"])
    emit(phase="torchrun_cli", what="python -m torch.distributed.run --standalone "
         "--nproc_per_node 1 -m <cli> --mesh 1: train_daclip one epoch, train_restoration 2 "
         "steps; one checkpoint each, loaded into the single-card model",
         train_daclip=dict(seconds=daclip_s, files=files, step=clip_steps,
                           log_tail=daclip_log[-600:]),
         train_restoration=dict(seconds=resto_s, files=resto_files, step=resto_step,
                                log_tail=resto_log[-600:]))
    check(clip_steps == CLIP_TREE[0] // CLIP_CLI_B, f"train_daclip took {clip_steps} steps")
    check(resto_step == 2, f"train_restoration stopped at step {resto_step}")


# -- phases 22-25: the alternative towers, CoCa and the HF text tower ---------
TOWER_MODELS = ["RN50", "convnext_base", "EVA02-B-16", "swin_base_patch4_window7_224",
                "vit_medium_patch16_gap_256", "vit_relpos_medium_patch16_cls_224",
                "ViT-M-16-alt", "coca_ViT-B-32"]
TOWER_CHECK_B, TOWER_TIME_B = 2, 64
TOWER_LIMIT = 1e-4         # f32 on the card vs f32 on the CPU, of the output's max
TOWER_COS_MIN = 0.99       # bf16 vs f32 on the card, each feature's cosine
TOWER_STEP_LIMIT = 1e-2    # an f32 step's update, card vs CPU, of the update's max
TOWER_STEPS = (("RN50", 8), ("convnext_base", 4))   # (model, B) of the f32 steps
TOWER_CLI_MODEL = "convnext_base"
COCA_MODEL, COCA_BEAM_B, COCA_SEQ = "coca_ViT-B-32", 4, 31   # SOT + 30 new tokens
HF_CONFIG = dict(model_type="roberta", vocab_size=50265, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072,
                 max_position_embeddings=514, type_vocab_size=1, pad_token_id=1,
                 bos_token_id=0, eos_token_id=2, layer_norm_eps=1e-5)   # roberta-base


def tower_state_dict(name, seed):
    """`seeded_state_dict` of `name`'s model, its BatchNorm variances
    1 + 0.2|r| and counters 0, its layer-scale gammas 0.5 + 0.1 r (their
    inits, 1e-6 to 1e-4, would hide the residual branches from the check)."""
    from daclip_torch.factory import create_model

    sd = seeded_state_dict(lambda: create_model(name), seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    for k, v in sd.items():
        leaf = k.rsplit(".", 1)[-1]
        r = torch.randn(v.shape, generator=gen, device="cuda")
        if leaf == "running_var":
            sd[k] = 1 + 0.2 * r.abs()
        elif leaf == "num_batches_tracked":
            sd[k] = torch.zeros((), dtype=torch.long, device="cuda")
        elif leaf == "gamma":
            sd[k] = 0.5 + 0.1 * r
    return sd


def tower_model(name, sd, device):
    from daclip_torch.factory import create_model

    model = create_model(name)
    model.load_state_dict({k: v.cpu() for k, v in sd.items()}, strict=True)
    return model.to(device).eval()


def seeded_images(B, res, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(B, 3, res, res, generator=gen).to(device)


def of_max(got, want):
    return float((got.float().cpu() - want.float().cpu()).abs().max()
                 / want.float().abs().max())


def run_towers():
    """Each tower model through create_model_and_transforms at its published
    width, seeded: f32 encode_image on the card against the same on the CPU
    at B = 2 (TOWER_LIMIT of the output's max), the bf16 features' cosine to
    the card's f32 (TOWER_COS_MIN), bf16 encode_image ms, images/s and peak
    memory at B = 64; no hand kernel launched."""
    import gc

    from daclip_torch.factory import create_model_and_transforms

    out = []
    for i, name in enumerate(TOWER_MODELS):
        t0 = time.perf_counter()
        cpu, _, pp_val = create_model_and_transforms(name, precision="fp32", seed=i)
        sd = tower_state_dict(name, seed=70 + i)
        cpu.load_state_dict({k: v.cpu() for k, v in sd.items()}, strict=True)
        cpu.eval()
        res = cpu.cfg.vision.image_size
        x = seeded_images(TOWER_CHECK_B, res, seed=80 + i)
        view = pp_val((np.random.RandomState(i).rand(res + 17, res + 9, 3) * 255).astype(
            np.uint8))
        check(view.shape == (res, res, 3), f"{name}: the val transform gave {view.shape}")
        with torch.no_grad():
            want = cpu.encode_image(x)
        card = cpu.to("cuda")
        reset_counts()
        with torch.no_grad():
            got = card.encode_image(x.cuda())
        err = of_max(got, want)
        bf16 = card
        bf16.dtype = torch.bfloat16  # precision="bf16": f32 parameters, bf16 activations
        xb = seeded_images(TOWER_TIME_B, res, seed=90 + i, device="cuda")
        with torch.no_grad():
            cos = float(torch.nn.functional.cosine_similarity(
                bf16.encode_image(x.cuda()).float(), got.float(), dim=-1).min())
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            feats = bf16.encode_image(xb)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            ms = time_ms(lambda: bf16.encode_image(xb), iters=10)
        counts = read_counts()
        row = dict(model=name, tower=type(bf16.visual).__name__, image_size=res,
                   params=sum(p.numel() for p in bf16.parameters()),
                   visual_params=sum(p.numel() for p in bf16.visual.parameters()),
                   f32_card_vs_cpu_of_max=err, min_cos_bf16_vs_f32=cos, batch=TOWER_TIME_B,
                   bf16_encode_image_ms=ms, images_per_s=TOWER_TIME_B / (ms / 1e3),
                   max_memory_allocated=peak, memory_allocated_before=resident,
                   seconds=time.perf_counter() - t0, launches=counts)
        emit(phase="towers", **row)
        out.append(row)
        check(err <= TOWER_LIMIT, f"{name}: f32 features card vs CPU {err} of their max")
        check(cos >= TOWER_COS_MIN, f"{name}: bf16 feature cosine {cos}")
        check(feats.shape == (TOWER_TIME_B, got.shape[1]) and bool(torch.isfinite(feats).all()),
              f"{name}: bf16 features {tuple(feats.shape)} or not finite")
        check(not any(counts.values()), f"{name}: the tower launched hand kernels: {counts}")
        del bf16, card, cpu, feats, xb
        gc.collect()
        torch.cuda.empty_cache()
    return out


def tower_step(name, B, seed):
    """One f32 plain-CLIP step (TF32 off) under --lock-image from seeded
    weights on a seeded batch, on the card and on the CPU: the loss and
    the update p_after - p_before of each, card against CPU as a share of
    its max (a card step that changed nothing reads 1); the locked
    parameters unchanged bit for bit on the card."""
    from daclip_torch.tokenizer import tokenize
    from daclip_torch.train.clip_train import ClipTrainConfig, init_state, make_train_step
    from daclip_torch.train.locking import build_update_mask

    cfg = ClipTrainConfig(lr=1e-3, eps=1e-3, warmup=1, total_steps=4, variant="clip")
    sd = tower_state_dict(name, seed)
    before = {k: v.float().cpu() for k, v in sd.items()}
    res = 224
    batch = {"images": seeded_images(B, res, seed + 1),
             "texts": torch.from_numpy(tokenize([f"a photo of scene {i}" for i in range(B)],
                                                context_length=77))}
    out = {}
    for device in ("cuda", "cpu"):
        model = tower_model(name, sd, device).train()
        mask = build_update_mask([n for n, _ in model.named_parameters()], lock_image=True)
        state = init_state(model, cfg, mask, device=device)
        reset_counts()
        _, m = make_train_step(model, cfg, None, device=device)(
            state, {k: v.to(device) for k, v in batch.items()})
        out[device] = (float(m["total_loss"]),
                       {n: p.detach().float().cpu() for n, p in model.named_parameters()},
                       read_counts())
        del model, state
    card, cpu = out["cuda"][1], out["cpu"][1]
    locked = [n for n, v in mask.items() if v == 0.0]
    moved_locked = [n for n in locked if not torch.equal(card[n], before[n])]
    u_err = {n: float(((card[n] - before[n]) - (p - before[n])).abs().max())
             for n, p in cpu.items()}
    u_max = max(float((p - before[n]).abs().max()) for n, p in cpu.items())
    worst = max(u_err, key=u_err.get)
    return dict(model=name, B=B, lr=cfg.lr, eps=cfg.eps, loss_card=out["cuda"][0],
                loss_cpu=out["cpu"][0],
                loss_rel_err=abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0]),
                locked_params=len(locked), trainable_params=len(mask) - len(locked),
                locked_moved=moved_locked, update_max=u_max,
                update_err_of_max=u_err[worst] / u_max, update_worst=worst,
                launches=out["cuda"][2])


def run_towers_train():
    """--lock-image training of the non-ViT towers: the f32 steps of
    TOWER_STEPS, card against CPU; then `cli.train_daclip.main --model
    convnext_base --lock-image` (bf16) for one epoch over train_daclip_cli's
    seeded CSV tree at B = 8, its step timed by a hook; then
    imagenet_zero_shot.evaluate on a seeded convnext_base .pt over a 3-class
    tree with the 80 templates; no hand kernel launched."""
    import gc
    import tempfile

    from daclip_torch.cli import train_daclip as cli
    from daclip_torch.eval import imagenet_zero_shot as zs
    from daclip_torch.train import clip_train
    from daclip_torch.utils import checkpoint as ckpt

    for i, (name, B) in enumerate(TOWER_STEPS):
        row = tower_step(name, B, seed=100 + 10 * i)
        emit(phase="towers_train", what="f32 step under --lock-image, card vs CPU", **row)
        check(row["update_err_of_max"] <= TOWER_STEP_LIMIT,
              f"{name}: the step's update card vs CPU {row['update_err_of_max']} of its max")
        check(row["loss_rel_err"] <= TOWER_LIMIT, f"{name}: loss {row['loss_rel_err']}")
        check(row["locked_params"] > 0 and not row["locked_moved"],
              f"{name}: locked parameters moved on the card: {row['locked_moved'][:5]}")
        check(not any(row["launches"].values()), f"{name}: step launched hand kernels")
        gc.collect()
        torch.cuda.empty_cache()

    records = []
    real_make = clip_train.make_train_step
    with tempfile.TemporaryDirectory() as d:
        root = pathlib.Path(d)
        train_csv = write_clip_tree(root / "train", CLIP_TREE[0], seed=41, filters=("up",))
        argv = ["--train-data", train_csv, "--model", TOWER_CLI_MODEL, "--lock-image",
                "--precision", "amp", "--batch-size", str(CLIP_CLI_B), "--workers",
                str(CLIP_CLI_WORKERS), "--logs", str(root / "logs"), "--name", "towers",
                "--lr", "2e-5", "--epochs", "1", "--device", "cuda"]
        reset_counts()
        clip_train.make_train_step = timed_steps(real_make, records)
        t0 = time.perf_counter()
        try:
            result = cli.main(argv)
        finally:
            clip_train.make_train_step = real_make
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = read_counts()
        epochs = ckpt.steps(str(root / "logs" / "towers" / "checkpoints"), ckpt.EPOCH)
        gaps = step_to_step_ms(records)
        emit(phase="towers_train", what=f"cli.train_daclip.main --model {TOWER_CLI_MODEL} "
             "--lock-image: one epoch", config=dict(precision="amp", B=CLIP_CLI_B,
                                                    workers=CLIP_CLI_WORKERS,
                                                    train_pairs=CLIP_TREE[0], png_rows="Up"),
             train_s=train_s, result=result, steps_run=[r["step"] for r in records],
             ms_per_step=[r["ms"] for r in records],
             median_ms_step_to_step=float(np.median(gaps)) if gaps else None,
             checkpoints=epochs, launches=counts)
        check(np.isfinite(result["best_loss"]) and epochs == [1],
              f"towers CLI: loss {result['best_loss']}, checkpoints {epochs}")
        check(len(records) == CLIP_TREE[0] // CLIP_CLI_B, f"towers CLI ran {len(records)} steps")
        check(not any(counts.values()), f"towers CLI launched hand kernels: {counts}")

        pt = root / "convnext.pt"
        torch.save({k: v.cpu() for k, v in tower_state_dict(TOWER_CLI_MODEL, 110).items()}, pt)
        write_class_tree(root / "zs", EVAL_CLASSES[:3], 4, EVAL_SIDES, seed=53, layout="")
        reset_counts()
        t0 = time.perf_counter()
        zres = zs.evaluate(str(pt), str(root / "zs"), TOWER_CLI_MODEL, device="cuda")
        counts = read_counts()
    emit(phase="towers_train", what=f"imagenet_zero_shot.evaluate, {TOWER_CLI_MODEL}",
         classes=3, prompts=3 * 80, images=12, seconds=time.perf_counter() - t0, launches=counts,
         **zres)
    check(all(0 <= v <= 1 for v in zres.values()), f"zero-shot {zres}")
    check(not any(counts.values()), f"zero-shot launched hand kernels: {counts}")


def gumbel_table(steps, shape, seed):
    """Per-step Gumbel noise drawn on the CPU from one seed, so that the
    card and the CPU sample from the same draws."""
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand((steps,) + tuple(shape), generator=gen).clamp_min(1e-30)
    return -torch.log(-torch.log(u))


def run_coca():
    """coca_ViT-B-32 at its published width, seeded, f32 on the card
    against the CPU: the forward's latents and caption logits (TOWER_LIMIT
    of their max) and coca_loss; generate_beam (6 beams in 3 groups,
    SOT + 30 tokens, B = 4) and generate (top-k 5, every draw given) with
    equal tokens; then bf16 ms of a caption batch of each; no hand kernel
    launched."""
    from daclip_torch.factory import get_tokenizer
    from daclip_torch.losses import coca_loss
    from daclip_torch.models import coca

    sd = tower_state_dict(COCA_MODEL, seed=120)
    models = {dev: tower_model(COCA_MODEL, sd, dev) for dev in ("cuda", "cpu")}
    vocab = models["cpu"].cfg.text.vocab_size
    tok = get_tokenizer(COCA_MODEL)
    text = torch.from_numpy(tok([f"a photo of a cat number {i}" for i in range(2)])).long()
    x = seeded_images(2, 224, seed=121)
    xb = seeded_images(COCA_BEAM_B, 224, seed=122)
    noise = gumbel_table(COCA_SEQ, (COCA_BEAM_B, vocab), seed=123)
    out = {}
    reset_counts()
    for dev, m in models.items():
        with torch.no_grad():
            o = m(x.to(dev), text.to(dev))
            loss = coca_loss(o["image_features"], o["text_features"], o["logits"], o["labels"],
                             o["logit_scale"])
        t0 = time.perf_counter()
        beam = coca.generate_beam(m, xb.to(dev), seq_len=COCA_SEQ)
        beam_s = time.perf_counter() - t0
        m.sampling_noise = lambda shape, step, generator=None, device=None: (
            noise[step].to(device))
        t0 = time.perf_counter()
        sampled = coca.generate(m, xb.to(dev), seq_len=COCA_SEQ, top_k=5)
        out[dev] = dict(o={k: v for k, v in o.items() if torch.is_tensor(v)},
                        loss={k: float(v) for k, v in loss.items()}, beam=beam.cpu(),
                        sampled=sampled.cpu(), beam_s=beam_s,
                        sample_s=time.perf_counter() - t0)
    counts = read_counts()
    card, cpu = out["cuda"], out["cpu"]
    errs = {k: of_max(card["o"][k], cpu["o"][k])
            for k in ("image_features", "text_features", "logits")}
    loss_err = max(abs(card["loss"][k] - cpu["loss"][k]) / abs(cpu["loss"][k])
                   for k in cpu["loss"])
    beam_equal = torch.equal(card["beam"], cpu["beam"])
    sampled_equal = torch.equal(card["sampled"], cpu["sampled"])
    bf16 = models.pop("cuda")
    bf16.dtype = torch.bfloat16
    del bf16.sampling_noise, models
    xb = xb.cuda()
    reset_counts()
    coca.generate_beam(bf16, xb, seq_len=COCA_SEQ)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    beam16 = coca.generate_beam(bf16, xb, seq_len=COCA_SEQ)
    torch.cuda.synchronize()
    beam_ms = (time.perf_counter() - t0) * 1e3
    gen = torch.Generator(device="cuda").manual_seed(124)
    t0 = time.perf_counter()
    sampled16 = coca.generate(bf16, xb, generator=gen, seq_len=COCA_SEQ, top_k=5)
    torch.cuda.synchronize()
    sample_ms = (time.perf_counter() - t0) * 1e3
    counts16 = read_counts()
    emit(phase="coca", model=COCA_MODEL, f32_card_vs_cpu_of_max=errs,
         coca_loss_card=card["loss"], coca_loss_cpu=cpu["loss"], loss_rel_err=loss_err,
         beam=dict(B=COCA_BEAM_B, beams=6, groups=3, seq_len=COCA_SEQ, equal=beam_equal,
                   tokens_card=card["beam"][0].tolist(), s_card_f32=card["beam_s"],
                   s_cpu_f32=cpu["beam_s"]),
         sampled=dict(top_k=5, equal=sampled_equal, tokens_card=card["sampled"][0].tolist(),
                      s_card_f32=card["sample_s"], s_cpu_f32=cpu["sample_s"]),
         bf16=dict(beam_ms_per_batch=beam_ms, sample_ms_per_batch=sample_ms, B=COCA_BEAM_B,
                   beam_tokens=beam16[0].tolist(), sampled_tokens=sampled16[0].tolist()),
         launches=counts, launches_bf16=counts16)
    check(all(e <= TOWER_LIMIT for e in errs.values()), f"CoCa f32 card vs CPU {errs}")
    check(loss_err <= TOWER_LIMIT, f"coca_loss card vs CPU {loss_err}")
    check(beam_equal, f"generate_beam: card {card['beam'].tolist()} CPU {cpu['beam'].tolist()}")
    check(sampled_equal, "generate under the same draws gave other tokens on the card")
    check(bool((beam16[:, 0] == 49406).all()) and beam16.shape == (COCA_BEAM_B, COCA_SEQ),
          "the bf16 beam search's output")
    check(not any(counts.values()) and not any(counts16.values()),
          f"CoCa launched hand kernels: {counts} / {counts16}")


def run_hf_text():
    """A roberta-base-shaped HFTextTower (mean pooler, mlp projection to
    512) from a config directory this phase writes, seeded: f32 features on
    the card against the CPU (TOWER_LIMIT of their max), the bf16 features'
    cosine (TOWER_COS_MIN), bf16 ms at B = 256 × 77 tokens; no hand kernel
    launched. Runs where transformers imports (the device phase says)."""
    import tempfile

    from transformers import AutoConfig

    from daclip_torch.models.hf_text import HFTextTower

    with tempfile.TemporaryDirectory() as d:
        cfg = dict(HF_CONFIG)
        AutoConfig.for_model(cfg.pop("model_type"), **cfg).save_pretrained(d)
        cpu = HFTextTower.from_config(d, 512, seed=130).eval()
    rng = np.random.RandomState(131)
    ids = torch.from_numpy(rng.randint(3, 50000, (TOWER_CHECK_B, 77))).long()
    ids[0, 40:] = 1  # padding
    with torch.no_grad():
        want = cpu(ids)
    card = cpu.to("cuda")
    reset_counts()
    with torch.no_grad():
        got = card(ids.cuda())
        err = of_max(got, want)
        bf16 = card.to(torch.bfloat16)
        cos = float(torch.nn.functional.cosine_similarity(
            bf16(ids.cuda()).float(), got.float(), dim=-1).min())
        big = torch.from_numpy(rng.randint(3, 50000, (256, 77))).long().cuda()
        ms = time_ms(lambda: bf16(big), iters=10)
    counts = read_counts()
    emit(phase="hf_text", config=HF_CONFIG, pooler=cpu.pooler_type, proj="mlp",
         f32_card_vs_cpu_of_max=err, min_cos_bf16_vs_f32=cos, batch=256, bf16_ms=ms,
         prompts_per_s=256 / (ms / 1e3), launches=counts)
    check(err <= TOWER_LIMIT, f"HF text f32 card vs CPU {err}")
    check(cos >= TOWER_COS_MIN, f"HF text bf16 cosine {cos}")
    check(not any(counts.values()), f"the HF text tower launched hand kernels: {counts}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    import daclip_torch  # noqa: F401  fails outside a checkout of the repo
    from daclip_torch.ops import _build

    if len(sys.argv) != 1:
        sys.exit(f"usage: {sys.argv[0]} (no arguments: every phase runs)")
    started = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit(phase="device", name=name, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count(),
         optional_packages=optional_packages())

    t0 = time.perf_counter()
    lib = _build.library()
    log = pathlib.Path(lib._name).with_suffix(".log")  # this library's build
    ptxas = ptxas_summary(log.read_text() if log.exists() else "")
    emit(phase="build", seconds=time.perf_counter() - t0, library=str(lib._name), ptxas=ptxas)
    # no instantiation of the linear-attention kernels may spill registers
    linattn = [ln for ln in ptxas if ln.startswith(("wrap::", "wrap_bwd::"))]
    spills = [ln for ln in linattn if not (re.search(r"(?<!\d)0 bytes spill stores", ln)
                                           and re.search(r"(?<!\d)0 bytes spill loads", ln))]
    check(linattn, "the build log names no linear-attention kernel")
    check(not spills, f"linear-attention kernels spill: {spills}")
    _LINATTN_PTXAS.update({ln.split(": ")[0]: ln for ln in linattn})
    check_flash_build(ptxas)
    check_pointwise_conv_build(ptxas)
    run_native_io()

    rows = run_kernels()
    alt_rows, core_path = run_kernels_alt()
    rows.update(alt_rows)
    conv_rows, conv_path = run_kernels_conv()
    rows.update(conv_rows)
    run_fixture()
    orbax_totals = run_orbax()
    resume_totals, resume_records = run_resume(smi)
    restorer, serve_totals, sds = run_serve()
    run_profile(restorer)
    serve_alt_totals, fwd = run_serve_alt(restorer, sds)
    forward_conv = run_forward_conv(restorer.unet, fwd)
    run_text(restorer, sds[1])
    gradio_totals = run_gradio(restorer)
    shard_totals = run_shard_tiles(restorer, sds, smi)
    del restorer, sds, fwd
    work = tempfile.TemporaryDirectory()
    lpips_weights = write_lpips_npz(pathlib.Path(work.name) / "alex.npz")
    run_lpips(lpips_weights)
    rows.update(run_kernels_bwd())
    for wiring in TRAIN_KERNELS:
        run_train_check(wiring)
    full_step, train_step_ms, train_totals = run_train()
    resume_ms = float(np.median([r["ms"] for r in resume_records]))
    emit(phase="resume_vs_train", resume_median_ms_per_step=resume_ms,
         train_median_ms_per_step=train_step_ms, over_train=resume_ms / train_step_ms,
         what="the resumed CLI's steps (hook-timed, each to a synchronize; the first holds "
              "its warm-up) beside the train phase's")
    run_profile_train(full_step, train_step_ms)
    del full_step
    full_step, step_ms, train_alt_totals = run_train(steps=3, wiring="v4_pointwise")
    run_profile_train(full_step, step_ms, wiring="v4_pointwise")
    del full_step
    train_cli_totals, test_lpips_totals = run_train_cli(train_step_ms, lpips_weights)
    work.cleanup()
    wild_rows, wild_totals = run_wild_ir()
    for key, more in wild_rows.items():  # after each list's own rows: the picks stay
        rows[key].extend(more)
    for key_rows in rows.values():
        check_above_bounds(key_rows)
    daclip = run_train_daclip()
    run_patch_dropout(daclip)
    t0 = time.perf_counter()
    with world_of_one() as mesh:
        ddp_totals, fsdp_totals = run_ddp_train(mesh, train_step_ms)
        run_ddp_daclip(mesh, daclip)
    run_two_ranks_one_card()
    run_torchrun_cli()
    multi_card_s = time.perf_counter() - t0
    inspect_dir = run_train_daclip_cli(daclip["step_ms"])
    del daclip
    run_train_daclip_wds()
    run_eval(inspect_dir)
    stage_totals = run_stage_profile()
    t0 = time.perf_counter()
    run_towers()
    run_towers_train()
    run_coca()
    run_hf_text()
    tower_phases_s = time.perf_counter() - t0

    # launches on each main path, each counted from 0 just before its run:
    # orbax (the fixture's restore from daclip_tpu's train dirs, T=20),
    # serve (the four requests), serve_alt (two requests per other wiring),
    # train (five timed steps), train_alt (three), ddp_train and fsdp_train
    # (three steps each, through DDP and FSDP2), train_cli (the CLI's two
    # runs, 2 steps and 4 validations), test_lpips (cli.test_restoration
    # --lpips-weights: two restores at T=100), wild_ir_train (train_wild's
    # two runs, 4 steps and 4 validations), wild_ir_test (test_wild's two
    # restores at T=100), wild_ir_predict (predict --wild-ir, one restore),
    # stage_profile (its 11 rows, 31 calls each), gradio (one request at
    # T=100), shard_tiles (the first sharded 1024² restore: two sampler runs
    # of 8 tiles, each UNet call split in two); for the attention core and
    # the 3×3 conv, which no model wiring calls, their paths in the kernels_alt
    # and kernels_conv phases, and the conv's in the hooked forward_conv
    paths = dict(serve=serve_totals, serve_alt=serve_alt_totals, gradio=gradio_totals,
                 orbax=orbax_totals, resume=resume_totals,
                 shard_tiles=shard_totals,
                 train=train_totals, ddp_train=ddp_totals, fsdp_train=fsdp_totals,
                 train_alt=train_alt_totals, train_cli=train_cli_totals,
                 test_lpips=test_lpips_totals, **wild_totals, stage_profile=stage_totals,
                 kernels=dict(core=core_path),
                 kernels_conv=dict(conv3x3=conv_path), forward_conv=dict(conv3x3=forward_conv))
    by_path = {key: {path: n[key] for path, n in paths.items() if n.get(key)}
               for key in kernel_counters()}
    bf16 = lambda key: [x for x in rows[key] if x["dtype"] == "bfloat16"]
    abs_err = {key: max(x["max_abs_err"] for x in bf16(key)) for key in rows}
    for fwd, bwd in (("wrap", "wrap_bwd"), ("flash", "flash_bwd")):
        # the forward also as training calls it, checked in kernels_bwd
        abs_err[fwd] = max(abs_err[fwd], *(x["forward"]["max_abs_err"] for x in bf16(bwd)))
    emit(phase="kernels_vs_library", what="each kernel's device ms over the one PyTorch call's "
         "on the same inputs (`device_ms`: CUDA events behind a queued sleep), where one "
         "computes the same function",
         rows=[dict(kernel=r["kernel"], shape=r["shape"], path=r.get("path"), form=r.get("form"),
                    over_library=r["device_ms"] / r["library_device_ms"])
               for key in ("flash", "dual", "flash_bwd", "conv3x3") for r in rows[key]
               if r.get("device_ms") and r.get("library_device_ms")])
    summary = []
    la_py, la_cu = "daclip_tpu/ops/linear_attention.py", "daclip_torch/csrc/linear_attention.cu"
    for key, name_, src, replaces, pick in (
            ("wrap", "attn_wrap", la_cu, f"{la_py}:491", 0),
            ("flash", "flash_self_attention", "daclip_torch/csrc/flash_attention.cu",
             "daclip_tpu/ops/flash_attention.py:68", 1),
            ("wrap_bwd", "attn_wrap_bwd", "daclip_torch/csrc/linear_attention_bwd.cu",
             f"{la_py}:885", 0),
            ("flash_bwd", "flash_self_attention_bwd",
             "daclip_torch/csrc/flash_attention_bwd.cu",
             "daclip_tpu/ops/flash_attention.py:199", 1),
            ("fused_v4", "linear_attention_fused", la_cu, f"{la_py}:310", 0),
            ("wrap_fused", "attn_wrap_fused", la_cu, f"{la_py}:199", 0),
            ("core", "linear_attention", la_cu, f"{la_py}:91", 0),
            ("dual", "dual_conv1x1", "daclip_torch/csrc/pointwise.cu",
             "daclip_tpu/ops/pointwise.py:121", 7),
            ("conv3x3", "conv3x3", "daclip_torch/csrc/conv3x3.cu",
             "daclip_tpu/ops/conv3x3.py:64", 0)):
        # the largest site of its path (dual: the single form; conv3x3: level 0)
        r = rows[key][pick]
        entry = dict(name=name_, route="cuda", source=src, replaces=replaces,
                     launches=sum(by_path[key].values()), launches_by_path=by_path[key],
                     shape=r["shape"], max_abs_err=abs_err[key])
        if "bwd" in key:
            entry.update(max_rel_err=max(x["max_rel_err"] for x in bf16(key)),
                         rel_err_is="max over gradients of max |kernel - plain| / max |plain|")
        elif key in ("flash", "core", "dual", "conv3x3"):
            rels = [x["max_rel_err"] for x in bf16(key)]
            if key == "flash":  # the forward also as training calls it
                rels += [x["forward"]["max_rel_err"] for x in bf16("flash_bwd")]
            entry.update(max_rel_err=max(rels), rel_err_is="max |kernel - plain| / max |plain|")
        check(entry["launches"] > 0, f"{name_} was launched no time on its path")
        if key == "wrap_bwd":  # its weight-gradient launch beside torch.matmul
            entry.update({k: r[k] for k in ("wgrad_ms", "wgrad_device_ms", "wgrad_library_ms",
                                            "wgrad_library_device_ms")})
        summary.append(dict(entry, ms=r["kernel_ms"], device_ms=r.get("device_ms"),
                            plain_ms=r["plain_ms"],
                            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                            library_ms=r["library_ms"],
                            library_device_ms=r.get("library_device_ms")))
    emit(phase="total", seconds=time.perf_counter() - started,
         multi_card_phases_seconds=multi_card_s, tower_phases_seconds=tower_phases_s)
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
