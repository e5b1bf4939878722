#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (``vdiff_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one output line each (any failure raises and exits non-zero):
  1. card: the GPU's name and power limit as nvidia-smi reports them;
  2. kernels: builds the CUDA kernels from vdiff_tpu_torch/csrc and holds
     each sampling attention kernel against its plain PyTorch twin at the
     sampler's shapes, f32 and bf16, and times both with CUDA events; the
     bf16 calls of B1 (attn_fwd_online) and B2 run the tensor-core
     attn_fwd_tc.cu (held to the f32 twin within 2^-8·|ref| + 2^-8·(P·|v|) +
     1e-4, at every CIFAR, celeba and mnist sampling shape: B1 at T=256 and
     T=64 (celeba N=12 and 9, mnist's one head of 128 at B=128), B2 at T=1024
     (mnist's too) and celeba's N=9 levels), each timed
     beside the f32-FMA kernel it replaced on the same inputs; their f32
     calls run the 3xTF32 tensor-core attn_fwd_tf32.cu, held to the f32 twin
     within 1e-4 and to an f64 twin within twice the f32-FMA kernel's largest
     error on the same inputs, and timed beside that FMA kernel;
  3. unet: the full-width cifar10_cond UNet (random weights, zero-init layers
     perturbed) in f32 on the GPU against the same UNet on the CPU, then the
     same with resample_with_res=False (strided-conv resampling: 15 attention
     calls a forward, all at T <= 512);
  3a. graph: the sampler with its CUDA graph (step 0 eager, one capture,
     the other steps replayed) against its eager loop from the same x_T, on
     the full-width bf16 cifar10_cond model: 8 DDIM steps at w=0 B=64 with
     the switches off, with VDIFF_FUSED_GN=1 and with both, CFG w=0.1 at
     B=32, and eta=1 from one generator seed, then 8 ancestral steps (fresh
     noise every step, from one generator seed) at w=0 B=64 and CFG w=0.1
     B=32; equal bit for bit, and the sampler's stats showing one capture,
     7 replays and the per-forward launches on the device;
  4. sample: the port's CLI (vdiff_tpu_torch.generate) draws 256-step DDIM
     samples at w=0 (B=64, two batches) and with CFG at w=0.1 (B=32), each
     batch replaying the step's graph, and the device must have run 17
     (attn_fwd_online) + 1 (attn_fwd_tc) launches per UNet forward;
  4q. ancestral: the same CLI without --use-ddim (its default sampler, at its
     default w=0.1), one batch of 64, 32 steps: 64 finite RGB PNGs, 17 + 1
     launches a forward;
  4e. nll: the eval CLI (vdiff_tpu_torch.eval --metrics nll) on phase 4's
     checkpoint in f32, 256 steps, 2 batches of 64 synthetic test images:
     finite bits/dim, forwards/s, and per forward B1 x17 and B2 x1 on
     attn_fwd_tf32.cu; then calc_all_bpd at B=2, T=8 on CUDA against the CPU,
     same weights and noise: total within 1e-3 relative, its forwards/s;
  4f. metric-nets: synthetic release-format FID Inception (with the IS head)
     and VGG16 weights written to <tmp>/precomputed; Inception's 2048-d
     features, its IS probabilities and VGG16's fc7 on the card vs the CPU
     for 8 images, f32, within 1e-3 of max|ref|; images/s of each at B=256;
  4g. rehearsal: generate writes 2 x 1024 PNGs of the full-width model (bf16,
     16 DDIM steps) as folders A and B, and 1024 noise PNGs; the fid CLI saves
     A's statistics, A's P&R manifold is cached, and the eval CLI runs fid,
     is and pr on A from <tmp>: FID(A, A's stats) < 1e-2, FID(A, B) finite
     and below FID(A, noise), P&R (1, 1), IS finite and >= 1;
  4h. evaluator: train_lib.Evaluator with the Trainer's graph-replayed eval
     sampler (16 DDIM steps, labels drawn), 3 batches of 128, against A's
     statistics: a finite FID;
  4i. gate: python -m vdiff_tpu_torch.quality_gate (train -> generate -> eval,
     each stage a process of its own) at the cifar10_cond widths in f32, as
     the JAX gate runs them: synthetic_flagship.json, 1 epoch of 128 (4
     steps), 256 PNGs at 16 DDIM steps, eval's fid, is, pr and nll on 64
     images, from <tmp> (4f's weights and 4g's statistics in ./precomputed):
     exit 0, the JSON last line, 256 finite PNGs, all four metrics finite,
     each stage's f32 launches read from its own summary, and the eval
     stage's nll forwards/s;
  4p. progressive: generate --progressive (16 steps at w=0.1, a snapshot
     every 4, B=16): 16 finite strips of 32x128 pixels;
  4a. fused-kernels: gn_film_silu_kernel (B10) and fused_gn_silu_conv3x3 (B11)
     against their twins at the fused sampling path's shapes (B=64: 32x32,
     16x16, 8x8; B10 at C=256 and 512 with and without SiLU and once with
     FiLM; B11 at 256->256 in its conv1 and conv2 forms), B10 at celeba's
     B=32 shapes (64x64 at C=192, 384 and 576, whose slabs take clusters of 8
     and 16 blocks, and 8x8 at 1536) with its plan printed and two bf16 calls
     held to the same bits, and, off the path, one C_in != C_out case, the
     bare conv with and without a skip and odd shapes (groups of 6 and 42, 4
     groups of 6, a non-square image, ragged
     tiles); f32 and bf16, then timed in bf16 beside the twin, the card's
     bound and F.group_norm on the same x; B11's bf16 calls
     run the tensor-core conv of gn_silu_conv3x3_tc.cu, timed beside the FMA
     conv of gn_silu_conv3x3.cu on the same inputs and cuDNN's bf16 conv
     alone (F.conv2d, channels_last: the library call of the bare conv);
  4b. fused-unet: the full-width bf16 cifar10_cond UNet at B=2 with
     VDIFF_FUSED_CONV=1 and VDIFF_FUSED_GN=1 against the same model with both
     off; one forward must launch B11 38 times and B10 35 times (B10 73 times
     with VDIFF_FUSED_GN=1 alone) beside the unchanged 17 + 1 of attention;
  4c. fused-sample: the generate CLI with both switches on (DDIM-256, w=0,
     B=64, one batch, bf16), then with VDIFF_FUSED_GN=1 alone: finite PNGs,
     the per-forward counts times 256 on the device, and samples/s beside the
     default path's;
  5. train-kernels: the training forward (attn_fwd_train, B3, at T <= 512,
     whose bf16 calls run attn_fwd_tc.cu; at T=1024 attn_fwd_qblk in f32,
     attn_fwd_tc in bf16) and the backward (attn_bwd: in f32 the 3xTF32 row
     and column kernels of attn_bwd_tf32.cu, attn_bwd_rows + attn_bwd_cols;
     attn_bwd_tc.cu in bf16, counted as B4 under attn_bwd at T <= 512 and as
     B5 under attn_bwd_tc at T=1024) against their twins at the train steps'
     shapes (B=128; T=64/256/1024 at C=256, two heads of 128 and mnist's one
     of 128, and celeba's at B=48: nine heads of 64 at T=1024, 256 and 64,
     twelve at T=64), f32 and bf16, timed with CUDA events, the tensor-core
     kernels beside the f32-FMA ones they replaced on the same inputs (the
     f32 forwards on attn_fwd_tf32.cu, held as in phase 2; the f32 backward
     within 1e-4 of max|ref| of the f32 twin per d(qkv) slot and against an
     f64 twin within twice the FMA pair's largest error, each kernel timed
     beside the FMA pass it replaced); both backwards beside SDPA's forward +
     backward (f32 with TF32 off in f32);
  6. train-unet: one full-width train step (loss, backward, clip, AdamW, EMA)
     in f32 at B=2 on the GPU against the same step on the CPU, same weights,
     t, noise and CFG mask, dropout off; one step must launch attn_fwd_train
     17 times, attn_fwd_qblk once, each backward kernel 18 times and
     attn_fwd_online never (f32: attn_fwd_tf32.cu and attn_bwd_tf32.cu);
  7. train-cli: the port's train CLI (vdiff_tpu_torch.train) on
     synthetic_flagship.json with --allow-bf16 --epochs 1 (4 steps of 128, the
     epoch-end sample grid, ckpt_last), then generate samples from ckpt_last;
     a bf16 step launches attn_fwd_tc and attn_bwd_tc once each, attn_bwd 17
     times and neither backward pass;
  7a. train-cli-remat: the same CLI run with --remat-policy conv and neither
     sample grid nor checkpoint (4 steps of 128); a step launches the forward
     kernels once for each attention call and again for each of the 17 in a
     checkpointed block (attn_fwd_train 33 times, attn_fwd_tc twice), the
     backward's as without remat;
  7b. mnist: mnist.json at full width (one input channel, hid 64, ch_mult
     [1, 2, 2], one head of 128: B1 x13 and B2 x1 a forward, B3 x13, B2, B4
     x13 and B5 a step): the f32 UNet on CUDA vs the CPU at B=2; the bf16
     UNet with both fused switches (B11 x20 at 128 channels, B10 x37) vs
     both off; B10 and B11 at every shape of that forward at B=128 vs their
     twins; the train CLI (bf16, 4 steps of 128) on an MNIST idx tree written
     from a seed (512 digits, resized to 32x32 by the loader), then the
     generate CLI's defaults (ancestral, CFG w=0.1) from its ckpt_last.pt, 16
     steps at B=64: finite greyscale 32x32 PNGs, the pinned launches;
  7c. uncond: cifar10_uncond.json (x0 output, snr_trunc, no labels): the f32
     UNet and one f32 train step on CUDA vs the CPU, and 8 bf16 steps, DDIM
     and ancestral, graph vs eager bit for bit;
  7d. learned: cifar10_cond's widths with model_var_type="learned" (6
     outputs) and loss_type="kl": one f32 train step and calc_all_bpd (B=2,
     T=8) on CUDA vs the CPU, and 8 bf16 ancestral steps at CFG w=0.1 B=32
     (the interpolated log-variance replayed), graph vs eager bit for bit;
  8. celeba-kernels: the head-dim 64 kernels (attn_fwd_pack1, attn_fwd_pack1_lse,
     attn_bwd_pack1, attn_bwd_pack1_kv) run at the shapes the celeba paths give
     them (CELEBA_KERNEL_SHAPES: the sampler's B=32, the train step's B=48)
     and are held against their twins, f32 and bf16: on the whole batch at
     T <= 1024, and at T=4096 on four batch slices of the same inputs and
     outputs (the twins' (B, N, T, T) f32 scores take 19 GB at B=48); then
     timed in bf16 there beside the twin, SDPA and the card's bound; all four
     run the tensor-core kernels in bf16 (B6 attn_fwd_tc.cu and B7 its lse
     entry, both held to B2's P·|v| limit; B8 attn_bwd_tc.cu; B9 that file's
     saved-statistics entry, vdiff_attn_bwd_tc_kv), each timed beside the
     f32-FMA kernel it replaced on the same inputs; in f32 B6 and B7 run
     attn_fwd_tf32.cu and its lse entry, B8 and B9 attn_bwd_tf32.cu's pair
     and its saved-statistics entry, held as in phases 2 and 5 (the f64 twin
     at T=4096 on the same four slices) and timed beside the FMA kernels;
  9. celeba-unet: the full-width celeba UNet (301 M parameters, 40 multi-hot
     tags, 'both' head) in f32 at B=1 on the GPU against the CPU; one forward
     must launch attn_fwd_pack1 10 times, attn_fwd_qblk 8 and attn_fwd_online 9
     (in bf16, phase 11, attn_fwd_tc takes attn_fwd_qblk's 8);
 10. celeba-train-unet: one full-width f32 train step at B=1 on the GPU against
     the CPU, dropout off, with the per-step launch counts of CELEBA_STEP_LAUNCHES;
 10a. celeba-graph (after 10b and 10c): phase 3a's check on the celeba model in
     bf16 at B=32, 4 steps, with the switches off, with VDIFF_FUSED_GN=1 (B10
     on thread-block clusters at 64x64) and with both switches;
 10b. celeba-nll: celeba's nll at full width in f32 (TF32 off), as the eval CLI
     runs it: attn_fwd_pack1 (B6) in f32, attn_fwd_tf32.cu, at B=1 and
     T=4096, 1024, 256 (N=6) and 256 (N=12) against its twins (f32, f64),
     timed beside the f32-FMA kernel it replaced, SDPA in f32 and the card's
     f32 bound; then calc_all_bpd at B=1, T=4 on seeded images and multi-hot
     tags, CUDA vs the CPU, same weights and noise: total within 1e-3
     relative, B6 x10, B2 x8 and B1 x9 a forward on the f32 kernels, its
     forwards/s;
 10c. celeba-fused: the bf16 celeba UNet at B=2 with both fused switches, with
     VDIFF_FUSED_GN=1 alone and with VDIFF_FUSED_CONV=1 alone, each against
     both off within 2^-4 of max|out| (the share printed), B11 x23 and B10 x77
     a forward with both; B11 at each of its forms on that path at B=32
     (conv1 and conv2 at 32x32x384, conv2 at 16x16x384, conv1 and conv2 at
     8x8x768) against its twin in f32 and bf16, timed beside cuDNN's conv;
 11. celeba-sample: the generate CLI on the random-weight model with
     celeba.json, B=32, 16 DDIM steps at w=0, bf16, tags drawn from a written
     list_attr_celeba.txt: finite PNGs and 10 / 8 / 9 launches per forward
     (attn_fwd_pack1 / attn_fwd_tc / attn_fwd_online); then the same with
     both fused switches (B11 x23 and B10 x77 a forward more), its samples/s
     beside the first run's;
 12. celeba-train: 3 steps of the bf16 train step at B=48 on seeded images and
     multi-hot tags, each with CELEBA_STEP_LAUNCHES_BF16, a finite loss and
     the peak device memory;
 12f. train-f32 (after 12): the default f32 train steps (TF32 off): CIFAR's
     img/s at B=128 as 4i's train stage measured it (the train CLI without
     --allow-bf16), and the celeba train step through make_train_step at
     B=48, one warm-up step and 3 timed ones (CUDA events): ms a step, a
     finite loss, CELEBA_STEP_LAUNCHES a step (B8 and B9 on attn_bwd_tf32.cu;
     path celeba_train_f32), the peak device memory;
 12a. remat: one celeba bf16 train step at B=48 (dropout 0.1) in each of the
     UNet's checkpointing modes (none, remat, remat_policy="conv"), from the
     same weights, draws and step generator, with cuDNN's deterministic
     algorithms, and a second no-remat step as the control: losses equal bit
     for bit, gradients bit for bit where the control's are, else within
     REMAT_GRAD_SPREAD times the control's spread (the line says which held);
     then a warm-up step and 3 timed steps of each with the default
     algorithms (CUDA events) and their peak device memory, which must order
     full < conv < none; the launches of each mode's first step
     (CELEBA_STEP_LAUNCHES_BF16, and with remat the forward of every
     attention call but the middle block's once more);
 12b. dist: the multi-GPU paths under python -m torch.distributed.run
     --standalone. One rank on NCCL runs (a) train --distributed (DDP) and (b)
     train --fsdp on synthetic_flagship.json with dropout off and cuDNN's
     autotuner off (bf16, B=128, 4 steps, no grid), each held to the plain
     train CLI run first in that process from the same seed: DDP's losses,
     params and EMA bit for bit, FSDP's within FSDP_LOSS_RTOL /
     FSDP_PARAM_RTOL (FSDP2's autograd nodes on each block's inputs make the
     backward sum some gradients in another order), TRAIN_STEP_LAUNCHES_BF16
     a step in each, their img/s and peak memory; then (c) generate --dp (32
     DDIM steps at w=0, two batches of 64), whose PNGs must be those of the
     plain generate CLI run before it there, 17 + 1 launches a forward; (d)
     two ranks sharing the card over
     gloo with CUDA tensors take one f32 DDP step of the full-width model
     (B=4 in all), held to the one-rank step on the global batch within the
     f32 step bounds, TRAIN_STEP_LAUNCHES a rank;
 12c. mp: the model-parallel serving modes, the plain generate CLI first at
     (b)'s settings, then two torchrun ranks sharing the card over gloo with
     CUDA tensors: (a) the full-width cifar10_cond f32 forward at B=2 under
     --tp, --spatial-shard and both, each within UNET_RTOL of the one-rank
     forward on the card, with each rank's parameter bytes, peak memory and
     17 + 1 launches; (b) generate --tp and generate --spatial-shard on
     phase 4's checkpoint (bf16, 16 DDIM steps at w=0, one batch of 16, the
     sampler's eager loop): finite PNGs, 17 + 1 launches a forward on each
     rank, samples/s beside the plain CLI's; (c) the full-width celeba bf16
     forward at B=2 under --tp within 4·2^-8 of max|ref| of one rank, the same
     weights in f32 within UNET_RTOL, B6 x10, B2 x8 and B1 x9 a rank; (d)
     generate --tp --progressive and --spatial-shard --progressive at 4p's
     settings in f32: 16 finite 32x128 strips, within UNET_RTOL of the plain
     CLI's f32 strips from the same seed (PNGs within one level), 17 + 1
     launches a forward on each rank;
 13. bench: python -m vdiff_tpu_torch.bench at full width with its sampling
     cut to 16 steps (--sample-steps), in this process: its JSON lines (the
     root bench's five, the canary and three arms, the headline last).
Every kernel's launches in the JSON record are counted on the main paths
(phases 4, 4q, 4e, 4i's gate_train, gate_generate and gate_eval, read back
from each stage's summary, 4c, 7, 7a, 7b's train and generate runs, 7c's
and 7d's graph runs, 7d's calc_all_bpd, 10b's calc_all_bpd, 11's two runs, 12,
12f,
12b's ddp_train_cli, fsdp_train_cli and dp_generate, read back from the
torchrun rank's summary.json files, and 12c's tp_generate, sp_generate,
tp_progressive and sp_progressive, summed over the two ranks),
each run with the counts set to 0 just before it and read just after:
"launches" is their sum over the paths, and "launches_by_path" each path's
own count. A sampling path replays CUDA
graphs, whose replays the wrappers do not count and whose captures launch
nothing: its device launches are the counts less the captures' plus the
replays', which the sampler reports (diffusion.py::_reverse). The line before last is the
kernels' JSON record (with each kernel's time, its twin's, one PyTorch
call's where there is one, the card's bound for the same work, and for the
tensor-core kernels of B1-B9 and B11 the FMA kernel's time on the same
inputs, "before_ms"; phases 2 and 5 list every bf16 shape of a wrapper under
"shapes", the first of them the record's own; B1's and B2's f32 calls, the
eval path's, are attn_fwd_online_f32 and attn_fwd_qblk, with phase 2's f32
shapes; B6's f32 calls, celeba's nll, are attn_fwd_pack1_f32, and B3's and
the backward pair's f32 calls, the default f32 train CLI's and the gate's
train stage's, attn_fwd_train_f32, attn_bwd_rows and attn_bwd_cols
(attn_bwd_tf32.cu), with phase 10b's and phase 5's f32 shapes; B7's, B8's and
B9's f32 calls, celeba's f32 train step's, attn_fwd_pack1_lse_f32,
attn_bwd_pack1_f32 and attn_bwd_pack1_kv_f32, with phase 8's f32 shapes;
the f32 records of attn_fwd_tf32.cu and attn_bwd_tf32.cu also carry their
largest error against the f64 twin, "f64_err", beside the FMA kernels',
"before_f64_err");
the last line is
{"ok": true, "device": {...}}.
Imports nothing of JAX.
"""

import collections
import copy
import glob
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vdiff_tpu_torch", "configs")
CONFIG = os.path.join(CONFIGS, "cifar10_cond.json")
TRAIN_CONFIG = os.path.join(CONFIGS, "synthetic_flagship.json")
CELEBA_CONFIG = os.path.join(CONFIGS, "celeba.json")
MNIST_CONFIG = os.path.join(CONFIGS, "mnist.json")
UNCOND_CONFIG = os.path.join(CONFIGS, "cifar10_uncond.json")
STEPS = 256
CELEBA_STEPS, CELEBA_SAMPLE_B, CELEBA_TRAIN_B, CELEBA_TRAIN_STEPS = 16, 32, 48, 3
FUSED_KERNELS = ("gn_film_silu_kernel", "fused_gn_silu_conv3x3")
KERNELS = ("attn_fwd_online", "attn_fwd_qblk", "attn_fwd_train", "attn_bwd", "attn_bwd_rows",
           "attn_bwd_cols", "attn_fwd_tc", "attn_bwd_tc", "attn_fwd_pack1", "attn_fwd_pack1_lse",
           "attn_bwd_pack1", "attn_bwd_pack1_kv") + FUSED_KERNELS


def _launches(**counts):
    """A launch count for every kernel: the given ones, 0 for the rest."""
    return {name: counts.get(name, 0) for name in KERNELS}


# attention calls per cifar10_cond UNet forward: 17 at T <= 512 (8 at T=256,
# 9 at T=64) go to attn_fwd_online (attn_fwd_train when training), 1 at
# T=1024 (up_1_us) to B2: attn_fwd_qblk in f32, attn_fwd_tc in bf16; every
# forward call runs a tensor-core kernel, attn_fwd_tf32.cu in f32,
# attn_fwd_tc.cu in bf16. A training backward runs each backward pass once per
# call in f32; in bf16 every call runs attn_bwd_tc.cu, counted under
# attn_bwd at T <= 512 (B4) and under attn_bwd_tc at T=1024 (B5).
ONLINE_PER_FWD, QBLK_PER_FWD = 17, 1
TRAIN_STEP_LAUNCHES = _launches(attn_fwd_train=17, attn_fwd_qblk=1, attn_bwd_rows=18,
                                attn_bwd_cols=18)
TRAIN_STEP_LAUNCHES_BF16 = _launches(attn_fwd_train=17, attn_fwd_tc=1, attn_bwd=17,
                                     attn_bwd_tc=1)
SAMPLE_FWD_LAUNCHES_BF16 = _launches(attn_fwd_online=ONLINE_PER_FWD, attn_fwd_tc=QBLK_PER_FWD)
# the fused inference kernels per cifar10_cond forward (27 residual and 18
# attention blocks). With both switches on: conv1 of the 11 blocks that
# neither resample nor take an up-path skip and all 27 conv2 go through
# fused_gn_silu_conv3x3; the 18 attention norms, out_norm and norm1 of the 4
# resampling and 12 up blocks through gn_film_silu_kernel. With VDIFF_FUSED_GN=1
# alone all 73 GroupNorms do. The attention counts do not move.
FUSED_FWD_LAUNCHES = _launches(attn_fwd_online=ONLINE_PER_FWD, attn_fwd_tc=QBLK_PER_FWD,
                               fused_gn_silu_conv3x3=38, gn_film_silu_kernel=35)
FUSED_GN_FWD_LAUNCHES = _launches(attn_fwd_online=ONLINE_PER_FWD, attn_fwd_tc=QBLK_PER_FWD,
                                  gn_film_silu_kernel=73)
FUSED_B = 64  # the fused sampling path's batch
# the celeba forward with VDIFF_FUSED_GN=1: all 100 GroupNorms through B10
CELEBA_FUSED_GN_FWD_LAUNCHES = _launches(attn_fwd_pack1=10, attn_fwd_tc=8, attn_fwd_online=9,
                                         gn_film_silu_kernel=100)
# with VDIFF_FUSED_CONV=1 the 23 residual-block convs at 384 and 768 channels
# go through B11 (fusable: C % 128, JAX's 14 MiB estimate; the 192- and
# 576-wide ones stay cuDNN's); with both switches the 77 GroupNorms left alone
# go through B10 (tests/test_torch_conv3x3.py pins both on the meta device)
CELEBA_FUSED_CONV_FWD_LAUNCHES = _launches(attn_fwd_pack1=10, attn_fwd_tc=8, attn_fwd_online=9,
                                           fused_gn_silu_conv3x3=23)
CELEBA_FUSED_FWD_LAUNCHES = dict(CELEBA_FUSED_CONV_FWD_LAUNCHES, gn_film_silu_kernel=77)
# B11's forms in that forward (H, W, C_in, C_out, film, skip, gn), held at
# the sampler's B=32: conv1 (no FiLM, no skip) x2 and conv2 (FiLM + skip) x7
# at 32x32x384, conv2 x1 at 16x16x384, conv1 x4 and conv2 x9 at 8x8x768
CELEBA_CONV_SHAPES = [(32, 32, 384, 384, False, False, True), (32, 32, 384, 384, True, True, True),
                      (16, 16, 384, 384, True, True, True), (8, 8, 768, 768, False, False, True),
                      (8, 8, 768, 768, True, True, True)]
# the graph phase: DDIM steps of each graph-vs-eager run (CIFAR, celeba)
GRAPH_STEPS, CELEBA_GRAPH_STEPS = 8, 4
# a replayed graph runs the eager step's kernels on the same inputs: no
# difference is allowed
GRAPH_ATOL = 0.0
# generate --progressive: steps and the snapshot interval (4 snapshots)
PROGRESSIVE_STEPS, PROGRESSIVE_FREQ = 16, 4
# the bench phase's sampling steps (the module's --sample-steps)
BENCH_SAMPLE_STEPS = 16
# the celeba UNet's 27 attention calls (head dim 64), routed as JAX routes
# them on a TPU without head padding: one forward launches the head-dim 64
# forward 10 times (T=1024 and T=256 at N=6, T=256 at N=12, T=4096 in
# up_1_us), the q-blocked kernel 8 times (N=9: T=256 and up_2_us's T=1024)
# and the online kernel 9 times (T=64); a train step runs the pack1 pair
# (forward + full-row backward) at 9 calls, the kv-streamed pair at T=4096,
# and B3/B2 + the two backward passes at the other 17. The pack1 wrappers run
# the tensor-core kernels in bf16 (attn_fwd_pack1 attn_fwd_tc.cu,
# attn_fwd_pack1_lse its lse entry, attn_bwd_pack1 attn_bwd_tc.cu,
# attn_bwd_pack1_kv its saved-statistics entry) and in f32 B1's online
# kernel, its lse entry, the two backward passes and attn_bwd_pack1_kv.cu;
# each wrapper counts only its own launches. In bf16 B2's calls and the
# T=1024 backward go to attn_fwd_tc and attn_bwd_tc, B4's 16 backward calls
# to attn_bwd_tc.cu under attn_bwd.
CELEBA_FWD_LAUNCHES = _launches(attn_fwd_pack1=10, attn_fwd_qblk=8, attn_fwd_online=9)
CELEBA_FWD_LAUNCHES_BF16 = _launches(attn_fwd_pack1=10, attn_fwd_tc=8, attn_fwd_online=9)
CELEBA_STEP_LAUNCHES = _launches(attn_fwd_pack1=9, attn_fwd_pack1_lse=1, attn_bwd_pack1=9,
                                 attn_bwd_pack1_kv=1, attn_fwd_train=16, attn_fwd_qblk=1,
                                 attn_bwd_rows=17, attn_bwd_cols=17)
CELEBA_STEP_LAUNCHES_BF16 = _launches(attn_fwd_pack1=9, attn_fwd_pack1_lse=1, attn_bwd_pack1=9,
                                      attn_bwd_pack1_kv=1, attn_fwd_train=16, attn_fwd_tc=1,
                                      attn_bwd=16, attn_bwd_tc=1)
# with remat (either mode) every down and up block is checkpointed and a
# checkpointed attention block runs its forward again in the backward (an
# autograd.Function saves after its forward, so a recompute re-runs it, as JAX
# re-runs its kernel): every attention call but the middle block's (8x8,
# attn_fwd_train) twice. CIFAR: 17 of 18 calls
# (16 attn_fwd_train, the T=1024 one attn_fwd_tc); celeba: 26 of 27.
TRAIN_STEP_LAUNCHES_BF16_REMAT = _launches(attn_fwd_train=33, attn_fwd_tc=2, attn_bwd=17,
                                           attn_bwd_tc=1)
CELEBA_STEP_LAUNCHES_BF16_REMAT = _launches(attn_fwd_pack1=18, attn_fwd_pack1_lse=2,
                                            attn_bwd_pack1=9, attn_bwd_pack1_kv=1,
                                            attn_fwd_train=31, attn_fwd_tc=2, attn_bwd=16,
                                            attn_bwd_tc=1)
# mnist.json (one input channel, hid 64, ch_mult [1, 2, 2], one head of 128):
# a forward runs 13 attention calls at T <= 512 (6 at T=256, 7 at T=64) and
# one at T=1024 (up_1_us), routed as JAX routes head dim 128: B1 and B2; a
# train step B3 and B4 at the 13, B2 and B5 at the one (tests/test_torch_mnist.py
# pins them on the meta device)
MNIST_FWD_LAUNCHES = _launches(attn_fwd_online=13, attn_fwd_qblk=1)
MNIST_FWD_LAUNCHES_BF16 = _launches(attn_fwd_online=13, attn_fwd_tc=1)
MNIST_STEP_LAUNCHES_BF16 = _launches(attn_fwd_train=13, attn_fwd_tc=1, attn_bwd=13, attn_bwd_tc=1)
# both fused switches: the 20 convs at 128 channels through B11, 37 of the 57
# GroupNorms through B10 (64, 128, 192 and 256 channels)
MNIST_FUSED_FWD_LAUNCHES = _launches(attn_fwd_online=13, attn_fwd_tc=1,
                                     fused_gn_silu_conv3x3=20, gn_film_silu_kernel=37)
# the mnist phase: the train CLI at the config's batch on a written idx tree
# of MNIST_DIGITS digits (4 steps), then the generate CLI's default sampler
# (ancestral, CFG w=0.1) at MNIST_SAMPLE_B for MNIST_SAMPLE_STEPS steps
MNIST_DIGITS, MNIST_TRAIN_B, MNIST_SAMPLE_B, MNIST_SAMPLE_STEPS = 512, 128, 64, 16
# B10's and B11's shapes in mnist's fused forward, at the CFG-doubled batch of
# MNIST_SAMPLE_B: B10 (H, W, C, film, silu), B11 (H, W, C_in, C_out, film,
# skip, gn)
MNIST_GN_SHAPES = [(32, 32, 64, False, True), (32, 32, 64, True, True), (16, 16, 64, False, True),
                   (16, 16, 64, True, True), (32, 32, 128, False, False),
                   (16, 16, 128, False, False), (8, 8, 128, False, False),
                   (32, 32, 128, True, True), (16, 16, 128, True, True), (8, 8, 128, True, True),
                   (32, 32, 192, False, True), (16, 16, 192, False, True),
                   (16, 16, 256, False, True), (8, 8, 256, False, True)]
MNIST_CONV_SHAPES = [(32, 32, 128, 128, True, True, True), (16, 16, 128, 128, True, True, True),
                     (16, 16, 128, 128, False, False, True), (8, 8, 128, 128, True, True, True),
                     (8, 8, 128, 128, False, False, True)]
# the generate CLI's default sampler (no --use-ddim), ancestral: one batch of
# ANCESTRAL_B for ANCESTRAL_STEPS steps at the CLI's default w=0.1
ANCESTRAL_B, ANCESTRAL_STEPS = 64, 32
REMAT_MODES = {"none": {}, "full": {"remat": True}, "conv": {"remat_policy": "conv"}}
REMAT_TIMED_STEPS = 3
# (B, T, N, kernels) at head dim 64: every shape the celeba paths give the
# head-dim 64 kernels, the sampler's B6 at T=4096 and the train step's at B=48
# (the sampler's B6 at T <= 1024 runs the same code at a smaller batch)
CELEBA_KERNEL_SHAPES = (
    (CELEBA_SAMPLE_B, 4096, 6, ("attn_fwd_pack1",)),                         # up_1_us
    (CELEBA_TRAIN_B, 4096, 6, ("attn_fwd_pack1_lse", "attn_bwd_pack1_kv")),  # up_1_us
    (CELEBA_TRAIN_B, 1024, 6, ("attn_fwd_pack1", "attn_bwd_pack1")),   # down_1_*, up_1_{0..3}
    (CELEBA_TRAIN_B, 256, 6, ("attn_fwd_pack1", "attn_bwd_pack1")),    # down_1_ds
    (CELEBA_TRAIN_B, 256, 12, ("attn_fwd_pack1", "attn_bwd_pack1")),   # up_3_us
)
# above this T the twins run on the batch slices 0, 1, B-2 and B-1 only
TWIN_FULL_BATCH_MAX_T = 1024

# the card's peaks (NVIDIA H100 SXM data sheet, dense): bf16 on the tensor
# cores, f32 outside them; HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12
# attention's peaks: f32-accurate attention runs on the tensor cores as
# 3xTF32 (attn_fwd_tf32.cu: three TF32 products per f32 product at the dense
# TF32 rate, 495 TFLOP/s), 165 TFLOP/s, above the FMA units' 67
ATTN_PEAK_FLOPS = {torch.bfloat16: PEAK_FLOPS[torch.bfloat16], torch.float32: 495e12 / 3}

# f32: both sides do f32 math; only the summation order differs.
F32_ATOL = 1e-4
# an f32 forward on the tensor cores (3xTF32) against the f64 twin: its
# largest error may be at most this many times the largest error of the
# f32-FMA kernel it replaced, on the same inputs ("f32 means f32")
F64_ERR_RATIO = 2.0
# bf16: the kernel does f32 math on the bf16 values and rounds once at the
# output, so it must sit within half a bf16 ulp (2^-8 relative) of the twin
# run in f32 on the same values, plus the f32 allowance.
BF16_RTOL = 2.0 ** -8
# UNet f32 on the GPU vs the CPU, relative to the output's scale: GEMM/conv
# summation order and the kernels' order differ across ~60 layers.
UNET_RTOL = 1e-3
# attention backward vs attention_qkv_bwd_reference, per d(qkv) slot (dq, dk,
# dv), relative to the slot's own scale max|ref| (at T=4096 dK/dV are ~1e-2).
# f32: both sides do f32 math; the sums run in other orders and the column
# pass takes P as exp(S - lse) where the twin divides by the row sum.
BWD_F32_RTOL = 1e-4
# bf16: kernel and twin round P and dS to bf16 as matmul operands at the same
# points and round each output once; their f32 sums differ in order, which can
# move a rounding by one step. One bf16 step of each output (2^-7 relative),
# plus 2^-8 of the slot's scale for P/dS operands that round the other way.
BWD_BF16_RTOL, BWD_BF16_SCALE = 2.0 ** -7, 2.0 ** -8
# fused kernels in f32 vs their twins: both sides do f32 math in another order
# (the conv sums 9·C_in products), relative to the output's scale.
FUSED_F32_RTOL = 1e-4
# fused conv in bf16 vs its twin before the twin's one cast: half a bf16 ulp
# of the output (BF16_RTOL) + the f32 allowance + one y operand that the
# kernel's and the twin's f32 SiLU round to neighbouring bf16 values, which
# moves one product by a bf16 step of y times a weight: 2^-7·max|y|·max|w|.
FUSED_FLIP_RTOL = 2.0 ** -7
# the bf16 UNet with both switches on vs the same model with both off: the
# fused forms keep A and B in f32 and round once where the default chain
# rounds at every step, so the two differ by bf16 noise grown over ~60 layers;
# the bound of the CPU tests' bf16 UNet comparisons, 2^-4 of the output's scale.
FUSED_UNET_RTOL = 2.0 ** -4
# one f32 train step on the GPU vs the CPU: the loss relative to itself and
# the gradients relative to the largest one (the UNet bound's reasoning, over a
# forward and a backward); the updated params relative to the step's size, lr.
# AdamW's first update is lr·g/(|g|+eps) ≈ lr·sign(g) per entry, so an entry
# whose gradient lies within the gradients' own tolerance of zero may move the
# other way on the other device: those entries are held to Adam's bound of
# 2·lr (plus the decay's share), all others to 1e-2·lr.
STEP_LOSS_RTOL, STEP_GRAD_RTOL, STEP_PARAM_RTOL, STEP_SIGN_BOUND = 1e-4, 1e-3, 1e-2, 2.01
STEP_LR = 2e-4
# a bf16 train step's gradients with remat vs without must be equal bit for
# bit under cuDNN's deterministic algorithms: the recompute runs the forward's
# kernels on the same inputs. Should two steps without remat not agree bit
# for bit themselves (an algorithm that sums in no fixed order), remat may
# differ from no remat by at most this many times their own largest
# difference, in units of the largest gradient; a recompute that drew other
# dropout bits moves the gradients by the size of a step (PERF.md §5).
REMAT_GRAD_SPREAD = 4.0
# lse of the head-dim 64 forward vs its twin, f32 on both sides: |lse| is
# at most ~20 here and the kernel's running max moves f32 roundings only
LSE_ATOL = 1e-4


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


# device cycles the card spins before a timed run (~10 ms at the H100's
# ~1.98 GHz), so the host enqueues the run while it waits
HOLD_CYCLES = 20_000_000


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms (CUDA events around ``iters`` calls).
    The card first spins for HOLD_CYCLES, so the host has queued the calls by
    the time the start event runs: a kernel shorter than its host-side
    launch (~15 µs through a wrapper) is timed on the device and not at the
    host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound(kind, B, T, N, C, dtype):
    """The least time the card could take for one attention call: the larger
    of its operations over attention's peak for the inputs' type
    (ATTN_PEAK_FLOPS: bf16 989 TFLOP/s; f32 165 TFLOP/s, three TF32 products
    per f32 product on the tensor cores) and its bytes (each input read once,
    each output written once) over the memory rate.
    Operations per (batch, head): 4·T²·C forward (q·kᵀ and P·v); 10·T²·C for
    a whole backward (S, dP, dQ, dK, dV); 6·T²·C for the row pass alone (S,
    dP, dQ), 8·T²·C for the column pass (S, dP, dK, dV)."""
    x = B * T * N * C * (2 if dtype == torch.bfloat16 else 4)  # one (B, T, N·C) array
    stats = B * N * T * 4  # one f32 (B, N, T) row statistic
    flops, nbytes = {
        "fwd": (4, 3 * x + x),
        "fwd_lse": (4, 3 * x + x + stats),
        "bwd": (10, 3 * x + x + 3 * x),
        "bwd_kv": (10, 3 * x + x + stats + x + 3 * x),
        "bwd_rows": (6, 3 * x + x + x + 2 * stats),
        "bwd_cols": (8, 3 * x + x + 2 * stats + 2 * x),
    }[kind]
    t_ops = flops * T * T * C * N * B / ATTN_PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _sdpa(qkv, N, g=None):
    """One call of torch's scaled_dot_product_attention on the same q/k/v
    (views of the fused qkv): the forward, or with ``g`` the forward and the
    backward to d(q, k, v). Timed as a yardstick only; the port never calls it."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    B, T, three_nc = qkv.shape
    q, k, v = qkv.view(B, T, 3, N, three_nc // (3 * N)).permute(2, 0, 3, 1, 4).unbind(0)
    if g is None:
        return lambda: sdpa(q, k, v)
    q, k, v = (a.detach().contiguous().requires_grad_() for a in (q, k, v))
    go = g.view(B, T, N, -1).transpose(1, 2)
    return lambda: torch.autograd.grad(sdpa(q, k, v), (q, k, v), go)


def phase_card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(out[0], flush=True)
    return out[0]


def phase_kernels():
    """Each kernel vs attention_qkv_reference on the same inputs. The bf16
    calls of B1 (attn_fwd_online) and B2 (attn_fwd_qblk → attn_fwd_tc) run
    attn_fwd_tc.cu, held by _check_tc_fwd, their f32 calls attn_fwd_tf32.cu,
    held by _check_f32_fwd; each is timed beside the f32-FMA kernel it
    replaced on the same inputs (``before_ms``), the twin and SDPA (in f32
    with TF32 off), at the CIFAR and celeba sampling shapes. Returns the
    per-kernel record at the sampler's shape (bf16, as --allow-bf16 runs),
    with every bf16 shape's under "shapes", and the f32 records (the eval
    path's) with every f32 shape's."""
    from vdiff_tpu_torch import kernels
    from vdiff_tpu_torch.ops import attention as A

    t0 = time.perf_counter()
    kernels.library()  # nvcc build (or the cached library) + load
    print(f"kernels: built {kernels.build_library()} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [  # (wrapper, B, T, N, C); first case per wrapper is the sampler's shape
        (A.attn_fwd_online, 64, 256, 1, 256),  # CIFAR sampling, 16x16
        (A.attn_fwd_online, 64, 64, 1, 256),   # CIFAR sampling, 8x8
        (A.attn_fwd_online, 32, 64, 12, 64),   # celeba sampling, 8x8
        (A.attn_fwd_online, 32, 64, 9, 64),    # celeba sampling, down_2_ds
        (A.attn_fwd_online, 64, 256, 2, 128),
        (A.attn_fwd_online, 128, 256, 1, 128),  # mnist sampling (B=64 CFG-doubled), 16x16
        (A.attn_fwd_online, 128, 64, 1, 128),   # mnist sampling, 8x8
        (A.attn_fwd_qblk, 64, 1024, 1, 256),  # CIFAR sampling, up_1_us
        (A.attn_fwd_qblk, 64, 1024, 2, 128),
        (A.attn_fwd_qblk, 32, 256, 9, 64),    # celeba sampling, the N=9 levels
        (A.attn_fwd_qblk, 32, 1024, 9, 64),   # celeba sampling, up_2_us
        (A.attn_fwd_qblk, 128, 1024, 1, 128),  # mnist sampling, up_1_us
    ]
    # the f32-FMA kernel each wrapper's calls ran before attn_fwd_tc.cu (bf16)
    # and attn_fwd_tf32.cu (f32)
    before = {A.attn_fwd_online: fma_fwd_online, A.attn_fwd_qblk: fma_fwd}
    record = {}
    for fn, B, T, N, C in cases:
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn(B, T, 3 * N * C, device="cuda", generator=gen).to(dtype)
            tc = dtype == torch.bfloat16  # B1's and B2's bf16 dispatch
            # B2's bf16 calls count under attn_fwd_tc, B1's under their own
            name = "attn_fwd_tc" if tc and fn is A.attn_fwd_qblk else fn.__name__
            tag = f"{name} B={B} T={T} N={N} C={C} {str(dtype)[6:]}"
            out = fn(qkv, N)
            errs = ({"max_abs_err": _check_tc_fwd(tag, out, qkv, N)} if tc else
                    _check_f32_fwd(tag, out, qkv, N, before[fn](qkv, N)))
            del out
            rec = {**errs, "ms": cuda_ms(lambda: fn(qkv, N)),
                   "before_ms": cuda_ms(lambda: before[fn](qkv, N)),
                   "plain_ms": cuda_ms(lambda: A.attention_qkv_reference(qkv, N)),
                   "library_ms": cuda_ms(_sdpa(qkv, N)), **_bound("fwd", B, T, N, C, dtype)}
            print(f"kernels: {tag}: " + _fmt(rec), flush=True)
            if tc:
                _keep_shape(record, name, (B, T, N, C), rec)
            else:  # f32: attn_fwd_tf32.cu, which the eval path's f32 UNet runs
                _keep_shape(record, F32_RECORDS[fn.__name__], (B, T, N, C), rec)
            del qkv
    torch.cuda.empty_cache()
    return record


# the kernels' JSON names of B1's and B2's f32 calls (attn_fwd_tf32.cu): B1's
# wrapper counts both dtypes, so its f32 record and launches go under a name
# of their own
F32_RECORDS = {"attn_fwd_online": "attn_fwd_online_f32", "attn_fwd_qblk": "attn_fwd_qblk"}
# ... and of every f32 call an f32 path makes (the eval CLI's nll, celeba's
# nll, the quality gate's f32 stages, the default f32 train steps): B6's and
# B3's f32 calls run attn_fwd_tf32.cu under attn_fwd_pack1's and
# attn_fwd_train's counts, B4's and B5's attn_bwd_tf32.cu's row and column
# kernels, each counted
F32_PATH_NAMES = dict(F32_RECORDS, attn_fwd_pack1="attn_fwd_pack1_f32",
                      attn_fwd_train="attn_fwd_train_f32", attn_bwd_rows="attn_bwd_rows",
                      attn_bwd_cols="attn_bwd_cols")


# ... and of the f32 calls that only celeba's f32 train step makes (phase
# 12f): B7 on attn_fwd_tf32.cu's lse entry, B8 and B9 on attn_bwd_tf32.cu
F32_CELEBA_RECORDS = {"attn_fwd_pack1_lse": "attn_fwd_pack1_lse_f32",
                      "attn_bwd_pack1": "attn_bwd_pack1_f32",
                      "attn_bwd_pack1_kv": "attn_bwd_pack1_kv_f32"}
F32_PATH_NAMES.update(F32_CELEBA_RECORDS)


def _f32_path(counts):
    """An f32 path's launches under the f32 kernels' JSON names."""
    if any(n for k, n in counts.items() if k not in F32_PATH_NAMES):
        fail(f"an f32 path launched {_nonzero(counts)}: a kernel without an f32 record")
    return {F32_PATH_NAMES[k]: n for k, n in counts.items() if k in F32_PATH_NAMES and n}


def _keep_shape(record, name, shape, rec):
    """The first shape's record is the kernel's own; every shape's, that one
    too, goes under its "shapes"."""
    record.setdefault(name, dict(rec, shapes=[]))["shapes"].append(
        dict(zip("BTNC", shape), **rec))


def _fma_launch(entry, qkv, N):
    """One launch of an f32-FMA forward entry (qkv, out, B, T, N, C, is_bf16,
    stream) on the same inputs, uncounted: the FMA kernels are yardsticks."""
    from vdiff_tpu_torch import kernels
    from vdiff_tpu_torch.ops import attention as A

    B, T, C = A._shape(qkv, N)
    out = torch.empty(B, T, N * C, dtype=qkv.dtype, device=qkv.device)
    err = getattr(kernels.library(), entry)(
        qkv.data_ptr(), out.data_ptr(), B, T, N, C, int(qkv.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    kernels.check(err, entry)
    return out


def fma_fwd(qkv, N):
    """B2's f32-FMA kernel (attn_fwd_qblk.cu) on the same inputs, uncounted:
    what bf16 calls ran before attn_fwd_tc, f32 calls before attn_fwd_tf32.cu."""
    return _fma_launch("vdiff_attn_fwd_qblk", qkv, N)


def _fma_bwd_args(qkv, N):
    """B, T, N, C, is_bf16, stream: the tail of every f32-FMA backward entry."""
    from vdiff_tpu_torch.ops import attention as A

    B, T, C = A._shape(qkv, N)
    return (B, T, N, C, int(qkv.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)


def fma_bwd_rows(qkv, g, N, dqkv):
    """The f32-FMA row pass (attn_bwd_rows.cu) on the same inputs, uncounted:
    dQ into ``dqkv``; returns its (lse, delta)."""
    from vdiff_tpu_torch import kernels

    B, T, three_nc = qkv.shape
    lse = torch.empty(B, N, T, dtype=torch.float32, device=qkv.device)
    delta = torch.empty_like(lse)
    err = kernels.library().vdiff_attn_bwd_rows(
        qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        *_fma_bwd_args(qkv, N))
    kernels.check(err, "vdiff_attn_bwd_rows")
    return lse, delta


def fma_bwd_cols(qkv, g, N, lse, delta, dqkv):
    """The f32-FMA column pass (attn_bwd_cols.cu) on the same inputs, uncounted."""
    from vdiff_tpu_torch import kernels

    err = kernels.library().vdiff_attn_bwd_cols(
        qkv.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(),
        *_fma_bwd_args(qkv, N))
    kernels.check(err, "vdiff_attn_bwd_cols")


def fma_bwd(qkv, g, N):
    """The f32-FMA backward pair (attn_bwd_rows.cu, then attn_bwd_cols.cu) on
    the same inputs, uncounted: what B4's, B5's and B8's bf16 calls ran before
    attn_bwd_tc.cu, and their f32 calls before attn_bwd_tf32.cu."""
    dqkv = torch.empty_like(qkv)
    lse, delta = fma_bwd_rows(qkv, g, N, dqkv)
    fma_bwd_cols(qkv, g, N, lse, delta, dqkv)
    return dqkv


def fma_fwd_online(qkv, N):
    """B1's f32-FMA online kernel (attn_fwd_online.cu) on the same inputs,
    uncounted: what B1's and B6's calls ran before attn_fwd_tc.cu (bf16) and
    attn_fwd_tf32.cu (f32)."""
    return _fma_launch("vdiff_attn_fwd_online", qkv, N)


def fma_fwd_train(qkv, N):
    """B3's f32-FMA kernel (attn_fwd_train.cu) on the same inputs, uncounted:
    what B3's calls ran before attn_fwd_tc.cu (bf16) and attn_fwd_tf32.cu
    (f32)."""
    return _fma_launch("vdiff_attn_fwd_train", qkv, N)


def fma_bwd_kv(qkv, out, lse, g, N):
    """B9's f32-FMA pair (attn_bwd_pack1_kv.cu's dQ/δ kernel, then
    attn_bwd_cols.cu) on the same inputs, uncounted: what B9's bf16 calls ran
    before attn_bwd_tc.cu's saved-statistics entry, and its f32 calls before
    attn_bwd_tf32.cu's."""
    from vdiff_tpu_torch import kernels

    dqkv = torch.empty_like(qkv)
    delta = torch.empty_like(lse)
    err = kernels.library().vdiff_attn_bwd_pack1_kv(
        qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
        delta.data_ptr(), *_fma_bwd_args(qkv, N))
    kernels.check(err, "vdiff_attn_bwd_pack1_kv")
    return dqkv


def fma_fwd_lse(qkv, N):
    """B7's f32-FMA kernel (the lse entry of attn_fwd_online.cu) on the same
    inputs, uncounted: what B7's calls ran before the lse entries of
    attn_fwd_tc.cu (bf16) and attn_fwd_tf32.cu (f32)."""
    from vdiff_tpu_torch import kernels
    from vdiff_tpu_torch.ops import attention as A

    B, T, C = A._shape(qkv, N)
    out = torch.empty(B, T, N * C, dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty(B, N, T, dtype=torch.float32, device=qkv.device)
    err = kernels.library().vdiff_attn_fwd_pack1_lse(
        qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), B, T, N, C,
        int(qkv.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "vdiff_attn_fwd_pack1_lse")
    return out, lse


def _fmt(rec):
    return " ".join(f"{k}={v}" for k, v in rec.items())


def _check_fwd(name, out, ref, dtype):
    """A forward kernel's output vs the twin run in f32 on the same values;
    returns the largest absolute error."""
    torch.cuda.synchronize()  # a fault during the launch surfaces here
    if out.shape != ref.shape or out.dtype != dtype:
        fail(f"{name}: got {tuple(out.shape)} {out.dtype}")
    err = (out.float() - ref).abs()
    tol = torch.full_like(ref, F32_ATOL) if dtype == torch.float32 else BF16_RTOL * ref.abs() + F32_ATOL
    if not bool(torch.isfinite(out).all()) or bool((err > tol).any()):
        fail(f"{name}: max err {err.max().item()} over tolerance "
             f"({'atol 1e-4' if dtype == torch.float32 else '2^-8 rel + 1e-4'})")
    return err.max().item()


def _f64_twin(qkv, N):
    """softmax(q·kᵀ/√C)·v and each row's logsumexp in f64 on the card, from
    the same values: (out (B, T, N·C), lse (B, N, T))."""
    B, T, three_nc = qkv.shape
    C = three_nc // (3 * N)
    q, k, v = qkv.double().reshape(B, T, 3, N, C).unbind(2)
    s = torch.einsum("btnc,bsnc->bnts", q, k).mul_(1.0 / math.sqrt(C))
    lse = torch.logsumexp(s, dim=-1)
    p = s.sub_(lse[..., None]).exp_()  # in place: one (B, N, T, T) f64 tensor
    return torch.einsum("bnts,bsnc->btnc", p, v).reshape(B, T, N * C), lse


def _check_f32_fwd(name, out, qkv, N, before, ref=None, lse=None, before_lse=None):
    """An f32 forward on the tensor cores (attn_fwd_tf32.cu), held two ways:
    within F32_ATOL of the f32 twin ``ref`` (attention_qkv_reference when
    None), and against the f64 twin on the same inputs with a largest error
    at most F64_ERR_RATIO times that of ``before``, the f32-FMA kernel's
    output. With ``lse`` (and the FMA kernel's ``before_lse``) the rows'
    logsumexp is held to LSE_ATOL of the f64 twin's. Prints both errors;
    returns {"max_abs_err": vs the f32 twin, "f64_err", "before_f64_err"}."""
    from vdiff_tpu_torch.ops import attention as A

    err = _check_fwd(name, out, A.attention_qkv_reference(qkv, N) if ref is None else ref,
                     torch.float32)
    want, want_lse = _f64_twin(qkv, N)
    err64 = (out.double() - want).abs().max().item()
    before64 = (before.double() - want).abs().max().item()
    del want
    line = (f"{name}: vs the f64 twin {err64}, the f32-FMA kernel {before64} "
            f"(ratio {err64 / before64 if before64 else math.inf:.3f}, limit {F64_ERR_RATIO})")
    if lse is not None:
        lse64 = (lse.double() - want_lse).abs().max().item()
        line += (f"; lse vs f64 {lse64}, the FMA kernel's "
                 f"{(before_lse.double() - want_lse).abs().max().item()}")
        if not lse64 <= LSE_ATOL:
            fail(f"{line}: lse over {LSE_ATOL}")
    print(line, flush=True)
    if not err64 <= F64_ERR_RATIO * before64:
        fail(f"{line}: over {F64_ERR_RATIO} times the FMA kernel's error")
    return {"max_abs_err": err, "f64_err": err64, "before_f64_err": before64}


def _check_tc_fwd(name, out, qkv, N):
    """attn_fwd_tc's bf16 output vs the twin run in f32 on the same values,
    per element within 2^-8·|ref| + 2^-8·(P·|v|) + 1e-4, where P·|v| is the
    twin run with |v| in place of v: rounding each weight e to bf16 moves it
    by at most 2^-9 relative, so an output moves by at most 2^-9·Σ p|v|; the
    factor 2 and the output's own half ulp (2^-9·|ref|) give the limit.
    Returns the largest absolute error."""
    from vdiff_tpu_torch.ops import attention as A

    torch.cuda.synchronize()  # a fault during the launch surfaces here
    x = qkv.float()
    ref = A.attention_qkv_reference(x, N)
    if out.shape != ref.shape or out.dtype != torch.bfloat16:
        fail(f"{name}: got {tuple(out.shape)} {out.dtype}")
    v = x[..., 2 * x.shape[-1] // 3:]
    v.abs_()
    tol = BF16_RTOL * ref.abs() + BF16_RTOL * A.attention_qkv_reference(x, N) + F32_ATOL
    err = (out.float() - ref).abs()
    if not bool(torch.isfinite(out).all()) or bool((err > tol).any()):
        fail(f"{name}: max err {err.max().item()} over tolerance (2^-8 |ref| + 2^-8 P|v| + 1e-4; "
             f"largest excess {(err - tol).max().item()})")
    return err.max().item()


def _check_bwd(name, got, ref, dtype):
    """d(qkv) of a backward kernel vs its twin in the same dtype, slot by slot;
    prints each slot's error beside its limit and its |ref| (largest, mean)
    and returns the largest absolute error."""
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != dtype:
        fail(f"{name}: got {tuple(got.shape)} {got.dtype}")
    worst, lines = 0.0, []
    for slot, (a, r) in zip("qkv", zip(got.float().chunk(3, -1), ref.float().chunk(3, -1))):
        scale = r.abs().max().item()
        err = (a - r).abs()
        if dtype == torch.float32:
            tol = torch.full_like(r, BWD_F32_RTOL * scale)
            limit = f"{BWD_F32_RTOL * scale:.3g}"
        else:
            tol = BWD_BF16_RTOL * r.abs() + BWD_BF16_SCALE * scale
            limit = f"2^-7|ref| + {BWD_BF16_SCALE * scale:.3g}"
        lines.append(f"d{slot} err {err.max().item():.3g} limit {limit} |ref| max {scale:.3g} "
                     f"mean {r.abs().mean().item():.3g}")
        if not bool(torch.isfinite(a).all()) or bool((err > tol).any()):
            fail(f"{name}: d{slot} max err {err.max().item()} (scale {scale}) over tolerance")
        worst = max(worst, err.max().item())
    print(f"{name}: " + "; ".join(lines), flush=True)
    return worst


def _f64_bwd_twin(qkv, g, N):
    """The exact attention backward in f64 on the card from the same values:
    d(qkv) (B, T, 3·N·C) of softmax(q·kᵀ/√C)·v against d(out) ``g``."""
    B, T, three_nc = qkv.shape
    C = three_nc // (3 * N)
    scale = 1.0 / math.sqrt(C)
    q, k, v = qkv.double().reshape(B, T, 3, N, C).unbind(2)
    do = g.double().reshape(B, T, N, C)
    p = torch.softmax(torch.einsum("btnc,bsnc->bnts", q, k).mul_(scale), dim=-1)
    ds = torch.einsum("btnc,bsnc->bnts", do, v)
    ds.sub_((p * ds).sum(-1, keepdim=True)).mul_(p)  # in place: dS = P∘(dP − δ)
    grads = (torch.einsum("bnts,bsnc->btnc", ds, k).mul_(scale),
             torch.einsum("bnts,btnc->bsnc", ds, q).mul_(scale),
             torch.einsum("bnts,btnc->bsnc", p, do))
    return torch.stack(grads, dim=2).reshape(B, T, 3 * N * C)


def _check_f32_bwd(name, got, ref, qkv, g, N, before):
    """An f32 backward on the tensor cores (attn_bwd_tf32.cu), held two ways:
    per d(qkv) slot within BWD_F32_RTOL of the f32 twin ``ref``
    (_check_bwd), and against the f64 twin on the same inputs with a largest
    error at most F64_ERR_RATIO times that of ``before``, the f32-FMA
    kernels' d(qkv). Prints each slot's f64 errors; returns {"max_abs_err":
    vs the f32 twin, "f64_err", "before_f64_err"}."""
    err = _check_bwd(name, got, ref, torch.float32)
    want = _f64_bwd_twin(qkv, g, N)
    slots = lambda a: [(x.double() - w).abs().max().item()
                       for x, w in zip(a.chunk(3, -1), want.chunk(3, -1))]
    err64, before64 = slots(got), slots(before)
    del want
    worst, worst_before = max(err64), max(before64)
    line = (f"{name}: vs the f64 twin dq/dk/dv {err64}, the f32-FMA kernels {before64} (ratio "
            f"{worst / worst_before if worst_before else math.inf:.3f}, limit {F64_ERR_RATIO})")
    print(line, flush=True)
    if not worst <= F64_ERR_RATIO * worst_before:
        fail(f"{line}: over {F64_ERR_RATIO} times the FMA kernels' error")
    return {"max_abs_err": err, "f64_err": worst, "before_f64_err": worst_before}


def phase_train_kernels():
    """The training kernels vs their twins at the train steps' shapes (B=128,
    the config's batch; celeba's at B=48: N=9 at T=1024, 256 and 64, N=12 at
    T=64), f32 and bf16, timed with CUDA events. The forward at T <= 512 is
    B3 (attn_fwd_train), at T=1024 B2 (attn_fwd_qblk in f32, attn_fwd_tc in
    bf16, whose sampling record stays phase 2's): attn_fwd_tc.cu in bf16,
    attn_fwd_tf32.cu in f32 (held by _check_f32_fwd), each timed beside the
    FMA kernel it replaced on the same inputs (``before_ms``). The backward
    is the FMA pair in f32 and attn_bwd_tc.cu in bf16, counted as B4
    (attn_bwd) at T <= 512 and as B5 (attn_bwd_tc) at T=1024, timed beside
    the pair on the same inputs (``before_ms``); SDPA's forward + backward
    (f32 with TF32 off in f32) is the library time of both. Returns the
    per-kernel records in bf16: B3 and B4 at T=256, C=256 (8 of the 18
    attention calls of a training forward; --allow-bf16), with every bf16
    shape of each under "shapes", and attn_bwd_tc at T=1024; and in f32
    (attn_fwd_train_f32, attn_bwd_rows, attn_bwd_cols) at the same first
    shape, with every f32 shape of each under "shapes"."""
    from vdiff_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [(128, 256, 1, 256), (128, 64, 1, 256), (128, 1024, 1, 256),
             (128, 256, 2, 128), (128, 1024, 2, 128), (CELEBA_TRAIN_B, 1024, 9, 64),
             (CELEBA_TRAIN_B, 256, 9, 64), (CELEBA_TRAIN_B, 64, 12, 64),
             (CELEBA_TRAIN_B, 64, 9, 64),
             (MNIST_TRAIN_B, 256, 1, 128), (MNIST_TRAIN_B, 64, 1, 128),  # mnist's head of 128
             (MNIST_TRAIN_B, 1024, 1, 128)]
    record = {}
    for B, T, N, C in cases:
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"B={B} T={T} N={N} C={C} {str(dtype)[6:]}"
            qkv = torch.randn(B, T, 3 * N * C, device="cuda", generator=gen).to(dtype)
            g = torch.randn(B, T, N * C, device="cuda", generator=gen).to(dtype)
            bf16 = dtype == torch.bfloat16  # B2's, B3's, B4's and B5's bf16 dispatch
            tc = bf16 and T > A.QBLK_THRESHOLD
            # the training forward: B3's kernel at T <= 512, B2's above
            fwd, fma = ((A.attn_fwd_train, fma_fwd_train) if T <= A.QBLK_THRESHOLD
                        else (A.attn_fwd_qblk, fma_fwd))
            name = "attn_fwd_tc" if tc else fwd.__name__
            out = fwd(qkv, N)
            errs = ({"max_abs_err": _check_tc_fwd(f"{name} {tag}", out, qkv, N)} if bf16 else
                    _check_f32_fwd(f"{name} {tag}", out, qkv, N, fma(qkv, N)))
            del out
            rec = {name: {
                **errs, "ms": cuda_ms(lambda: fwd(qkv, N), iters=10),
                "before_ms": cuda_ms(lambda: fma(qkv, N), iters=10),
                "plain_ms": cuda_ms(lambda: A.attention_qkv_reference(qkv, N), iters=10),
                "library_ms": cuda_ms(_sdpa(qkv, N), iters=10), **_bound("fwd", B, T, N, C, dtype)}}
            bwd_name = "attn_bwd_tc" if tc else "attn_bwd"
            dqkv = A.attn_bwd(qkv, g, N)
            ref = A.attention_qkv_bwd_reference(qkv, g, N)
            if bf16:
                errs = {"max_abs_err": _check_bwd(f"{bwd_name} {tag}", dqkv, ref, dtype)}
            else:  # attn_bwd_tf32.cu, also against the f64 twin beside the FMA pair
                errs = _check_f32_bwd(f"{bwd_name} {tag}", dqkv, ref, qkv, g, N,
                                      fma_bwd(qkv, g, N))
            del ref
            plain = cuda_ms(lambda: A.attention_qkv_bwd_reference(qkv, g, N), iters=10)
            # SDPA's forward + backward, the yardstick of the whole backward
            library = cuda_ms(_sdpa(qkv, N, g), iters=10)
            if bf16:  # attn_bwd_tc.cu, beside the FMA pair it replaced
                rec[bwd_name] = {**errs,
                                 "ms": cuda_ms(lambda: A.attn_bwd(qkv, g, N), iters=10),
                                 "before_ms": cuda_ms(lambda: fma_bwd(qkv, g, N), iters=10),
                                 "plain_ms": plain, "library_ms": library,
                                 **_bound("bwd", B, T, N, C, dtype)}
            else:
                # the 3xTF32 row and column kernels (attn_bwd_tf32.cu), each
                # beside the f32-FMA pass it replaced; no one PyTorch call
                # computes either alone: SDPA's f32 forward + backward, the
                # whole backward's yardstick, is the library time of the pair
                lse, delta = A.attn_bwd_rows(qkv, g, N, dqkv)
                rec["attn_bwd_rows"] = {
                    **errs, "plain_ms": plain, "library_ms": library,
                    "ms": cuda_ms(lambda: A.attn_bwd_rows(qkv, g, N, dqkv), iters=10),
                    "before_ms": cuda_ms(lambda: fma_bwd_rows(qkv, g, N, dqkv), iters=10),
                    **_bound("bwd_rows", B, T, N, C, dtype)}
                rec["attn_bwd_cols"] = {
                    **errs, "plain_ms": plain, "library_ms": library,
                    "ms": cuda_ms(lambda: A.attn_bwd_cols(qkv, g, N, lse, delta, dqkv), iters=10),
                    "before_ms": cuda_ms(lambda: fma_bwd_cols(qkv, g, N, lse, delta, dqkv),
                                         iters=10),
                    **_bound("bwd_cols", B, T, N, C, dtype)}
                pair = rec["attn_bwd_rows"]["ms"] + rec["attn_bwd_cols"]["ms"]
                before = rec["attn_bwd_rows"]["before_ms"] + rec["attn_bwd_cols"]["before_ms"]
                print(f"train-kernels: the f32 pair {tag}: {pair} ms (the FMA pair {before}, "
                      f"{before / pair:.2f}x), {pair / library:.2f}x SDPA f32 forward+backward "
                      f"({library}), bound {_bound('bwd', B, T, N, C, dtype)}", flush=True)
                del lse, delta
            for name, r in rec.items():
                pair = name in ("attn_bwd_rows", "attn_bwd_cols")
                print(f"train-kernels: {name} {tag}: " + _fmt(r)
                      + (f" (plain: whole backward; library: SDPA forward+backward; bound of "
                         f"the whole backward {_bound('bwd', B, T, N, C, dtype)})"
                         if pair else " (library: SDPA forward+backward)" if "bwd" in name else ""),
                      flush=True)
                if bf16 and name in ("attn_fwd_train", "attn_bwd"):
                    _keep_shape(record, name, (B, T, N, C), r)
                elif bf16 and name not in record:
                    record[name] = r
                elif not bf16 and name in ("attn_fwd_train", "attn_bwd_rows", "attn_bwd_cols"):
                    # the f32 kernels the quality gate's f32 train stage runs
                    _keep_shape(record, F32_PATH_NAMES[name], (B, T, N, C), r)
            del qkv, g, dqkv
            torch.cuda.empty_cache()
    return record


def _perturbed_unet(cfg, num_classes=10, multitags=False, dtype=torch.float32, in_channels=3):
    """Full-width UNet with random weights (a learned-variance config's with
    2·C outputs); zero-init layers get noise so the output (and every check on
    it) is not trivially zero."""
    from vdiff_tpu_torch.factory import build_unet

    gen = torch.Generator().manual_seed(1234)
    model = build_unet(cfg["model"], in_channels=in_channels,
                       model_out_type=cfg["diffusion"]["model_out_type"], num_classes=num_classes,
                       multitags=multitags, dtype=dtype, generator=gen,
                       model_var_type=cfg["diffusion"]["model_var_type"])
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim >= 2 and not bool(p.any()):
                p.normal_(0.0, 0.05, generator=gen)
    return model.eval()


def _unet_parity(name, model, x, t, y, want):
    """One f32 forward on the GPU against the CPU, and its launch counts."""
    with torch.inference_mode():
        ref = model(x, t, y)
        model_gpu = copy.deepcopy(model).cuda()
        before = _counts()
        out = model_gpu(x.cuda(), t.cuda(), None if y is None else y.cuda()).cpu()
    launched = {k: v - before[k] for k, v in _counts().items()}
    del model_gpu
    scale = max(1.0, ref.abs().max().item())
    err = (out - ref).abs().max().item()
    print(f"{name}: full width B={x.shape[0]} f32, cuda vs cpu max_abs_err={err} "
          f"(|ref|max={scale}), kernel launches {launched}", flush=True)
    if not bool(torch.isfinite(out).all()) or err > UNET_RTOL * scale:
        fail(f"{name}: cuda vs cpu max err {err} > {UNET_RTOL} * {scale}")
    if launched != want:
        fail(f"{name}: one forward launched {launched}, expected {want}")


def phase_unet(cfg):
    model = _perturbed_unet(cfg)
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 32, 32, 3, generator=gen)
    t = torch.rand(2, generator=gen)
    y = torch.tensor([3.0, 0.0])  # a class and the CFG null label
    _unet_parity("unet: cifar10_cond", model, x, t, y,
                 _launches(attn_fwd_online=ONLINE_PER_FWD, attn_fwd_qblk=QBLK_PER_FWD))
    # strided-conv resampling: the resample blocks and their attention go,
    # leaving 7 calls at T=256 and 8 at T=64
    strided = _perturbed_unet(dict(cfg, model=dict(cfg["model"], resample_with_res=False)))
    _unet_parity("unet: cifar10_cond resample_with_res=False", strided, x, t, y,
                 _launches(attn_fwd_online=15))
    return model


def _wrappers():
    """Every kernel wrapper by name (each carries its ``launches`` count)."""
    from vdiff_tpu_torch.ops import counted_wrappers

    wrappers = counted_wrappers()
    if set(wrappers) != set(KERNELS):
        fail(f"the package counts {sorted(wrappers)}, this script {sorted(KERNELS)}")
    return wrappers


def _counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def _reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def _train_step_parity(name, cfg, model, x, y, keep, want):
    """One f32 train step (loss, backward, clip, AdamW, EMA) on CUDA vs the
    CPU with the same weights, t, noise and CFG keep mask (an unconditional
    config: no labels, no mask); the CUDA step's launch counts must equal
    ``want``."""
    from vdiff_tpu_torch.factory import build_diffusion
    from vdiff_tpu_torch.train_lib import Optimizer, make_train_step

    cond = cfg["conditional"]
    diffusion, timesteps = build_diffusion(cfg["diffusion"], w_guide=cond["w_guide"],
                                           p_uncond=cond["p_uncond"])
    gen = torch.Generator().manual_seed(11)
    draws = [{"t": torch.rand(x.shape[0], generator=gen),
              "noise": torch.randn(x.shape, generator=gen), "keep": keep}]
    to = lambda a, device: None if a is None else a.to(device)

    def run(device):
        m = copy.deepcopy(model).to(device)
        ema = copy.deepcopy(m).requires_grad_(False)
        opt = Optimizer(m.parameters(), lr=STEP_LR, weight_decay=1e-3, warmup=0, grad_norm=1.0)
        step = make_train_step(m, diffusion, opt, timesteps, use_cfg=cond["use_cfg"],
                               ema_model=ema)
        d = [{k: to(v, device) for k, v in draws[0].items()}]
        before = _counts()
        loss = step(x.to(device), to(y, device), 0, 0, draws=d).item()
        launched = {k: v - before[k] for k, v in _counts().items()}
        grads = torch.cat([p.grad.flatten().cpu() for p in m.parameters()])
        params = torch.cat([p.detach().flatten().cpu() for p in m.parameters()])
        return loss, grads, params, launched

    cpu_loss, cpu_g, cpu_p, _ = run("cpu")
    loss, g, p, launched = run("cuda")
    loss_err = abs(loss - cpu_loss) / abs(cpu_loss)
    grad_scale = cpu_g.abs().max().item()
    grad_err = (g - cpu_g).abs().max().item() / grad_scale
    moved = (p - cpu_p).abs() / STEP_LR
    signed = cpu_g.abs() > STEP_GRAD_RTOL * grad_scale
    param_err, near_zero_err = moved[signed].max().item(), moved.max().item()
    print(f"{name}: full width B={x.shape[0]} f32 one step, cuda vs cpu: loss {loss} vs "
          f"{cpu_loss} (rel {loss_err}), grads max err {grad_err} of the largest, params max "
          f"err {param_err} of lr ({near_zero_err} of lr over the {int((~signed).sum())} entries "
          f"whose gradient is within tolerance of zero), launches {launched}", flush=True)
    if not (math.isfinite(loss) and loss_err <= STEP_LOSS_RTOL and grad_err <= STEP_GRAD_RTOL
            and param_err <= STEP_PARAM_RTOL and near_zero_err <= STEP_SIGN_BOUND):
        fail(f"{name}: cuda step disagrees with the cpu step")
    if launched != want:
        fail(f"{name}: one step launched {launched}, expected {want}")


def phase_train_unet(cfg):
    """One full-width f32 train step of cifar10_cond at B=2, dropout off."""
    model = _perturbed_unet(dict(cfg, model=dict(cfg["model"], drop_rate=0.0)))
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(12)) * 2 - 1
    _train_step_parity("train-unet: cifar10_cond", cfg, model, x, torch.tensor([3, 7]),
                       torch.tensor([True, False]), TRAIN_STEP_LAUNCHES)


def phase_train_cli(tmp):
    """The train CLI end to end, then generate from its ckpt_last; returns the
    kernels' launch counts of the training run."""
    from vdiff_tpu_torch import generate, train

    _reset_counts()
    t0 = time.perf_counter()
    summary = train.main(["--config-path", TRAIN_CONFIG, "--allow-bf16", "--epochs", "1",
                          "--exp-dir", os.path.join(tmp, "exps")])
    seconds = time.perf_counter() - t0
    # the epoch-end sample grid replays a CUDA graph: its captures launched
    # nothing, its replays launched uncounted (diffusion.py::_reverse)
    sampler = summary["sampler"]
    launched = {k: n - sampler["captured_launches"].get(k, 0)
                + sampler["replayed_launches"].get(k, 0) for k, n in _counts().items()}
    ckpt = os.path.join(summary["ckpt_dir"], "ckpt_last.pt")
    print(f"train-cli: synthetic_flagship bf16 B=128, {summary['steps']} steps, loss "
          f"{summary['loss']}, {summary['img_per_s']} img/s over the steps after the first, "
          f"{seconds:.1f} s with the sample grid ({sampler['eager_steps']} eager step, "
          f"{sampler['captures']} capture, {sampler['replays']} replays) and checkpoint, device "
          f"launches {_nonzero(launched)}", flush=True)
    steps = summary["steps"]
    if steps != 4 or summary["loss"] is None or not math.isfinite(summary["loss"]):
        fail(f"train-cli: {steps} steps, loss {summary['loss']}")
    if not (os.path.exists(ckpt) and os.path.exists(os.path.join(summary["image_dir"], "1.png"))):
        fail("train-cli: no ckpt_last.pt or sample grid")
    want = {k: v * steps for k, v in TRAIN_STEP_LAUNCHES_BF16.items()}
    # the epoch-end sample grid: one inference forward per sampling step
    want["attn_fwd_online"] += ONLINE_PER_FWD * STEPS
    want["attn_fwd_tc"] += QBLK_PER_FWD * STEPS
    if launched != want:
        fail(f"train-cli: launches {launched}, expected {want}")
    out = generate.main(["--config-path", TRAIN_CONFIG, "--ckpt-path", ckpt, "--use-ema",
                         "--use-ddim", "--allow-bf16", "--sample-timesteps", "8", "--batch-size",
                         "16", "--total-size", "16", "--save-dir", os.path.join(tmp, "gen")])
    print(f"train-cli: generate from ckpt_last: {out['images']} samples, 8 DDIM steps, "
          f"finite={out['finite']}", flush=True)
    if out["images"] != 16 or not out["finite"]:
        fail(f"train-cli: generate from ckpt_last gave {out}")
    return launched


def phase_train_cli_remat(tmp):
    """The train CLI with --remat-policy conv, without the sample grid and
    the checkpoint; returns the kernels' launch counts of the run."""
    from vdiff_tpu_torch import train

    _reset_counts()
    summary = train.main(["--config-path", TRAIN_CONFIG, "--allow-bf16", "--epochs", "1",
                          "--remat-policy", "conv", "--num-save-images", "0",
                          "--max-ckpts-kept", "0", "--exp-dir", os.path.join(tmp, "exps_remat")])
    launched = _counts()
    print(f"train-cli-remat: synthetic_flagship bf16 B=128 remat_policy=conv, "
          f"{summary['steps']} steps, loss {summary['loss']}, {summary['img_per_s']} img/s over "
          f"the steps after the first, device launches {_nonzero(launched)}", flush=True)
    steps = summary["steps"]
    if steps != 4 or summary["loss"] is None or not math.isfinite(summary["loss"]):
        fail(f"train-cli-remat: {steps} steps, loss {summary['loss']}")
    want = {k: v * steps for k, v in TRAIN_STEP_LAUNCHES_BF16_REMAT.items()}
    if launched != want:
        fail(f"train-cli-remat: launches {launched}, expected {want}")
    return launched


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def _device_launches(name, counted, stats, per_fwd, forwards):
    """The launches a sampling run made on the device, from the wrappers'
    counts and the sampler's ``stats`` (diffusion.py::_reverse): a graph's
    capture counts its wrappers' calls and launches nothing, its replays
    launch them uncounted. They must be ``per_fwd`` times the run's UNet
    forwards, and so must the captured step's count times each batch's
    replays; every batch ran one eager step, one capture and the rest as
    replays. Returns them."""
    device = {k: counted[k] - stats["captured_launches"].get(k, 0)
              + stats["replayed_launches"].get(k, 0) for k in counted}
    steps = stats["eager_steps"] + stats["replays"]
    want = {k: v * forwards for k, v in per_fwd.items()}
    print(f"{name}: {stats['eager_steps']} eager step(s), {stats['captures']} graph capture(s), "
          f"{stats['replays']} replays; device launches {_nonzero(device)}", flush=True)
    if device != want or stats["launches"] != want:
        fail(f"{name}: device launches {device} (sampler: {stats['launches']}), expected {want}")
    if steps != forwards or stats["eager_steps"] != stats["captures"]:
        fail(f"{name}: {stats['eager_steps']} eager steps, {stats['captures']} captures and "
             f"{stats['replays']} replays for {forwards} steps: the graph did not run")
    if stats["captured_launches"] != {k: v * stats["captures"] for k, v in per_fwd.items()}:
        fail(f"{name}: the captures counted {stats['captured_launches']}, expected {per_fwd} each")
    return device


def phase_sample(model, tmp):
    """The CLI end to end (the steps after each batch's first replay its
    CUDA graph); returns the device's launches over the phase, the
    checkpoint it wrote and the w=0 run's samples/s."""
    from vdiff_tpu_torch import generate

    ckpt = os.path.join(tmp, "model.pt")
    sd = model.state_dict()
    torch.save({"model": sd, "ema": {"shadow": sd}}, ckpt)
    runs = [("w=0", "0", 64, 128), ("cfg w=0.1", "0.1", 32, 32)]
    rates, launched = {}, collections.Counter()
    for name, w, bs, total in runs:
        _reset_counts()
        summary = generate.main([
            "--config-path", CONFIG, "--ckpt-path", ckpt, "--save-dir", os.path.join(tmp, "out"),
            "--use-ema", "--use-ddim", "--allow-bf16", "--sample-timesteps", str(STEPS),
            "--w-guide", w, "--batch-size", str(bs), "--total-size", str(total), "--seed", "0",
        ])
        forwards = STEPS * (total // bs)
        device = _device_launches(f"sample: {name}", _counts(), summary["stats"],
                                  SAMPLE_FWD_LAUNCHES_BF16, forwards)
        launched.update(device)
        pngs = len(glob.glob(os.path.join(summary["save_dir"], "*.png")))
        rates[name] = summary["images"] / summary["seconds"]
        print(f"sample: {name} B={bs} x{total // bs} batches, {STEPS} DDIM steps: "
              f"{summary['images'] / summary['seconds']} samples/s (the first batch's warm-up "
              f"included), {pngs} PNGs, finite={summary['finite']}", flush=True)
        if pngs != total or not summary["finite"]:
            fail(f"sample {name}: {pngs} PNGs (want {total}), finite={summary['finite']}")
    return {k: launched[k] for k in KERNELS}, ckpt, rates["w=0"]


def phase_ancestral_sample(ckpt, tmp):
    """The generate CLI's default sampler (no --use-ddim: ancestral, fresh
    noise every step from the CLI's generator) at its default w=0.1 on phase
    4's checkpoint, bf16, one batch of ANCESTRAL_B, ANCESTRAL_STEPS steps:
    finite PNGs, one a sample, and the per-forward launches every step (the
    CFG-doubled batch is one forward). Returns the device's launches."""
    from vdiff_tpu_torch import generate

    _reset_counts()
    summary = generate.main([
        "--config-path", CONFIG, "--ckpt-path", ckpt, "--save-dir", os.path.join(tmp, "ancestral"),
        "--use-ema", "--allow-bf16", "--sample-timesteps", str(ANCESTRAL_STEPS), "--batch-size",
        str(ANCESTRAL_B), "--total-size", str(ANCESTRAL_B), "--seed", "0"])
    launched = _device_launches("ancestral", _counts(), summary["stats"], SAMPLE_FWD_LAUNCHES_BF16,
                                ANCESTRAL_STEPS)
    pngs = glob.glob(os.path.join(summary["save_dir"], "*.png"))
    heads = {_png_header(f) for f in pngs}
    print(f"ancestral: generate without --use-ddim, w=0.1 B={ANCESTRAL_B}, {ANCESTRAL_STEPS} "
          f"ancestral steps bf16: {summary['images'] / summary['seconds']} samples/s (the warm-up "
          f"included), {len(pngs)} PNGs of {heads} (width, height, colour type), "
          f"finite={summary['finite']}", flush=True)
    if len(pngs) != ANCESTRAL_B or heads != {(32, 32, 2)} or not summary["finite"]:
        fail(f"ancestral: {len(pngs)} PNGs of {heads}, finite={summary['finite']}")
    return launched


def _png_header(path):
    """(width, height, colour type: 0 greyscale, 2 RGB) from a PNG's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(26)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        fail(f"{path}: not a PNG")
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big"), head[25]


def phase_progressive(ckpt, tmp):
    """generate --progressive on the card: PROGRESSIVE_STEPS DDIM steps at
    w=0.1, a snapshot every PROGRESSIVE_FREQ, one 32x(32·L) strip a sample."""
    from vdiff_tpu_torch import generate

    _reset_counts()
    B, L = 16, PROGRESSIVE_STEPS // PROGRESSIVE_FREQ
    summary = generate.main([
        "--config-path", CONFIG, "--ckpt-path", ckpt, "--save-dir", os.path.join(tmp, "prog"),
        "--use-ema", "--use-ddim", "--allow-bf16", "--sample-timesteps", str(PROGRESSIVE_STEPS),
        "--progressive", "--pred-freq", str(PROGRESSIVE_FREQ), "--batch-size", str(B),
        "--total-size", str(B), "--seed", "0"])
    _device_launches("progressive", _counts(), summary["stats"], SAMPLE_FWD_LAUNCHES_BF16,
                     PROGRESSIVE_STEPS)
    sizes = {_png_header(f)[:2] for f in glob.glob(os.path.join(summary["save_dir"], "*.png"))}
    n = len(glob.glob(os.path.join(summary["save_dir"], "*.png")))
    print(f"progressive: w=0.1 B={B}, {PROGRESSIVE_STEPS} DDIM steps, a snapshot every "
          f"{PROGRESSIVE_FREQ}: {n} strips of {sizes} (width, height), finite={summary['finite']}",
          flush=True)
    if n != B or sizes != {(32 * L, 32)} or not summary["finite"]:
        fail(f"progressive: {n} strips of {sizes}, finite={summary['finite']}")


def _graph_vs_eager(name, model, cfg, w_guide, x_T, y, steps, per_fwd, eta=0.0, use_ddim=True):
    """``steps`` DDIM steps (ancestral ones without ``use_ddim``) of p_sample
    with the CUDA graph (one eager step, one capture, steps-1 replays)
    against the eager loop from the same x_T, and where the steps draw noise
    (DDIM eta > 0, ancestral) the same generator seed: the same kernels on
    the same inputs, so the samples must be equal bit for bit (GRAPH_ATOL).
    Both must launch ``per_fwd`` per step on the device, the capture once.
    Returns the graph run's launches on the device."""
    from vdiff_tpu_torch.factory import build_diffusion

    diffusion, _ = build_diffusion(cfg["diffusion"], w_guide=w_guide, sample_timesteps=steps,
                                   continuous_gate=False)
    sampler = "DDIM" if use_ddim else "ancestral"
    out, stats, ms = {}, {}, {}
    for graph in (True, False):
        gen = torch.Generator(device="cuda").manual_seed(21) if eta or not use_ddim else None
        stats[graph] = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[graph] = diffusion.p_sample(model, x_T, label=y, use_ddim=use_ddim, eta=eta,
                                        generator=gen, graph=graph, stats=stats[graph])
        torch.cuda.synchronize()
        ms[graph] = (time.perf_counter() - t0) * 1e3
    diff = (out[True] - out[False]).abs().max().item()
    moved = (out[True] - x_T).abs().max().item()
    g = stats[True]
    print(f"graph: {name}: {steps} {sampler} steps, graph vs eager max_abs_diff={diff} (bound "
          f"{GRAPH_ATOL}), moved {moved} from x_T, {ms[True]:.1f} ms against {ms[False]:.1f} ms "
          f"(host clock, one capture included), {g['eager_steps']} eager step, {g['captures']} "
          f"capture, {g['replays']} replays, captured launches {_nonzero(g['captured_launches'])}",
          flush=True)
    if not bool(torch.isfinite(out[True]).all()) or diff > GRAPH_ATOL or not moved > 0.1:
        fail(f"graph: {name}: graph vs eager max diff {diff} (bound {GRAPH_ATOL}), moved {moved}")
    want = {k: v * steps for k, v in per_fwd.items()}
    if (g["eager_steps"], g["captures"], g["replays"]) != (1, 1, steps - 1) or \
            g["captured_launches"] != per_fwd or g["launches"] != want or \
            stats[False]["launches"] != want:
        fail(f"graph: {name}: stats {stats}, expected {per_fwd} a step")
    return g["launches"]


def phase_graph(cfg):
    """The full-width bf16 cifar10_cond model (seeded random weights, zero-init
    layers perturbed): graph against eager at w=0 B=64 with the switches off,
    with VDIFF_FUSED_GN=1 and with both switches, CFG w=0.1 at B=32, DDIM
    eta=1 at B=64, and the ancestral sampler (the generate CLI's default,
    fresh noise every step) at w=0 B=64 and CFG w=0.1 B=32."""
    model = _perturbed_unet(cfg, dtype=torch.bfloat16).cuda()
    gen = torch.Generator(device="cuda").manual_seed(20)
    per_fwd = {(False, False): SAMPLE_FWD_LAUNCHES_BF16, (False, True): FUSED_GN_FWD_LAUNCHES,
               (True, True): FUSED_FWD_LAUNCHES}
    for B, w, eta, conv, gn, ddim in (
            (FUSED_B, 0.0, 0.0, False, False, True), (FUSED_B, 0.0, 0.0, False, True, True),
            (FUSED_B, 0.0, 0.0, True, True, True), (32, 0.1, 0.0, False, False, True),
            (FUSED_B, 0.0, 1.0, False, False, True), (FUSED_B, 0.0, 0.0, False, False, False),
            (32, 0.1, 0.0, False, False, False)):
        x_T = torch.randn(B, 32, 32, 3, device="cuda", generator=gen)
        y = (torch.arange(B, device="cuda") % 10 + 1).float()
        sampler = f"eta={eta}" if ddim else "ancestral"
        with _switches(conv, gn):
            _graph_vs_eager(f"cifar10_cond w={w} B={B} {sampler} VDIFF_FUSED_CONV={int(conv)} "
                            f"VDIFF_FUSED_GN={int(gn)}", model, cfg, w, x_T, y, GRAPH_STEPS,
                            per_fwd[conv, gn], eta, use_ddim=ddim)


def _celeba_bf16(cfg, model):
    """The celeba ``model``'s weights in the bf16 UNet on the card, for inference."""
    from vdiff_tpu_torch.factory import build_unet

    with torch.device("meta"):
        bf16 = build_unet(cfg["model"], in_channels=3,
                          model_out_type=cfg["diffusion"]["model_out_type"], num_classes=40,
                          multitags=True, dtype=torch.bfloat16)
    bf16.load_state_dict({k: v.cuda() for k, v in model.state_dict().items()}, assign=True)
    return bf16.eval()


def phase_celeba_graph(cfg, bf16):
    """The celeba model in bf16 at B=32: graph against eager, with the
    switches off, with VDIFF_FUSED_GN=1 (B10 on thread-block clusters at
    64x64) and with both switches (B11 at 384 and 768 channels too)."""
    _, y = _celeba_inputs(CELEBA_SAMPLE_B, torch.Generator().manual_seed(22))
    gen = torch.Generator(device="cuda").manual_seed(23)
    for conv, gn, per_fwd in ((False, False, CELEBA_FWD_LAUNCHES_BF16),
                              (False, True, CELEBA_FUSED_GN_FWD_LAUNCHES),
                              (True, True, CELEBA_FUSED_FWD_LAUNCHES)):
        x_T = torch.randn(CELEBA_SAMPLE_B, 64, 64, 3, device="cuda", generator=gen)
        with _switches(conv, gn):
            _graph_vs_eager(f"celeba w=0 B={CELEBA_SAMPLE_B} VDIFF_FUSED_CONV={int(conv)} "
                            f"VDIFF_FUSED_GN={int(gn)}", bf16, cfg, 0.0, x_T, y.cuda(),
                            CELEBA_GRAPH_STEPS, per_fwd)
    torch.cuda.empty_cache()


def phase_celeba_fused(bf16):
    """celeba with the fused switches: (a) the bf16 UNet at B=2 with both on,
    with VDIFF_FUSED_GN alone and with VDIFF_FUSED_CONV alone, each against
    both off within FUSED_UNET_RTOL of the output's scale, and each
    forward's launches; (b) B11 at every form of that forward
    (CELEBA_CONV_SHAPES) at the sampler's B=32 against its twin, f32 and
    bf16, timed beside cuDNN's bf16 conv. Returns (b)'s bf16 records."""
    gen = torch.Generator().manual_seed(24)
    x, y = _celeba_inputs(2, gen)
    t = torch.rand(2, generator=gen)
    _fused_unet("celeba-fused: unet", bf16, x.cuda(), t.cuda(), y.cuda(), CELEBA_FWD_LAUNCHES_BF16,
                (("both switches", True, True, CELEBA_FUSED_FWD_LAUNCHES),
                 ("VDIFF_FUSED_GN alone", False, True, CELEBA_FUSED_GN_FWD_LAUNCHES),
                 ("VDIFF_FUSED_CONV alone", True, False, CELEBA_FUSED_CONV_FWD_LAUNCHES)))
    kgen = torch.Generator(device="cuda").manual_seed(25)
    B = CELEBA_SAMPLE_B
    shapes = []
    for H, W, C, CO, film, skip, gn in CELEBA_CONV_SHAPES:
        rec = _conv_case("celeba-fused: fused-kernels (on the path)", kgen, B, H, W, C, CO, film,
                         skip, gn)
        shapes.append(dict(B=B, H=H, W=W, C=C, CO=CO, film=film, skip=skip, gn=gn, **rec))
    torch.cuda.empty_cache()
    return shapes


def phase_bench():
    """python -m vdiff_tpu_torch.bench at full width with the sampling cut to
    BENCH_SAMPLE_STEPS steps, in this process: every root line and arm once,
    the headline last, each positive."""
    from vdiff_tpu_torch import bench

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lines = bench.main(["--sample-steps", str(BENCH_SAMPLE_STEPS)])
    metrics = [line["metric"] for line in lines]
    want = {"session_canary_matmul_tf_per_sec", "cifar10_train_img_per_sec_per_chip_bf16",
            "celeba_samples_per_sec_per_chip_ddim256", "celeba_train_img_per_sec_per_chip",
            "cifar10_samples_per_sec_per_chip_ddim256_cfg0.1",
            "celeba_samples_per_sec_per_chip_ddim256_fused_gn",
            "cifar10_samples_per_sec_per_chip_ddim256_eager",
            "cifar10_samples_per_sec_per_chip_ddim256_fused_gn", bench.HEADLINE}
    print(f"bench: {len(lines)} lines in {time.perf_counter() - t0:.1f} s", flush=True)
    if sorted(metrics) != sorted(want) or metrics[-1] != bench.HEADLINE or \
            not all(line["value"] > 0 for line in lines):
        fail(f"bench: lines {metrics}")


def _gn_bound(B, H, W, C, dtype, film):
    """B10's least time: x read and y written once in ``dtype`` (plus the f32
    gamma/beta and the FiLM rows) over the memory rate, against ~10 f32
    operations per element (two for the sums' FMA and add, the multiply-add,
    the SiLU) over the f32 peak."""
    size = 2 if dtype == torch.bfloat16 else 4
    nbytes = 2 * B * H * W * C * size + 2 * C * 4 + (2 * B * C * size if film else 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 10 * B * H * W * C / PEAK_FLOPS[torch.float32]
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _conv_bound(B, H, W, C, CO, dtype, gn, film, skip):
    """B11's least time: 2·9·C_in·C_out operations per output pixel over the
    peak for the activations' type, against its inputs read once (x, the f32
    OIHW weights and bias, gamma/beta, FiLM rows, skip) and its output written
    once over the memory rate."""
    size = 2 if dtype == torch.bfloat16 else 4
    nbytes = (B * H * W * (C + CO * (2 if skip else 1)) * size + (9 * C * CO + CO) * 4
              + (2 * C * 4 if gn else 0) + (2 * B * C * size if film else 0))
    t_ops = 2 * B * H * W * 9 * C * CO / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _fused_inputs(B, H, W, C, CO, dtype, gen, film, skip):
    """Seeded inputs as the UNet hands them over: x with a mean and a spread,
    FiLM rows as the two strided halves of one (B, 2C) projection in x's type,
    f32 parameters, LeCun-scaled OIHW weights."""
    x = (torch.randn(B, H, W, C, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
    gamma = torch.randn(C, device="cuda", generator=gen) * 0.1 + 1
    beta = torch.randn(C, device="cuda", generator=gen) * 0.1
    shift = scale = None
    if film:
        shift, scale = (torch.randn(B, 2 * C, device="cuda", generator=gen) * 0.2).to(dtype).chunk(
            2, dim=-1)
    w = torch.randn(CO, C, 3, 3, device="cuda", generator=gen) * (9 * C) ** -0.5
    bias = torch.randn(CO, device="cuda", generator=gen) * 0.1
    res = torch.randn(B, H, W, CO, device="cuda", generator=gen).to(dtype) if skip else None
    return x, gamma, beta, shift, scale, w, bias, res


def _check_fused(name, out, ref, dtype, extra_atol=0.0):
    """A fused kernel's output vs its twin in f32 (for bf16: the twin on the
    same bf16 values before its one cast); returns the largest absolute error."""
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != dtype or ref.dtype != torch.float32:
        fail(f"{name}: got {tuple(out.shape)} {out.dtype} against {tuple(ref.shape)} {ref.dtype}")
    err = (out.float() - ref).abs()
    if dtype == torch.float32:
        tol = torch.full_like(ref, FUSED_F32_RTOL * max(1.0, ref.abs().max().item()))
    else:
        tol = BF16_RTOL * ref.abs() + F32_ATOL + extra_atol
    if not bool(torch.isfinite(out).all()) or bool((err > tol).any()):
        fail(f"{name}: max err {err.max().item()} over tolerance (largest excess "
             f"{(err - tol).max().item()})")
    return err.max().item()


def _gn_case(phase, gen, Bc, H, W, C, groups, film, silu):
    """gn_film_silu_kernel (B10) at one shape vs its twin in f32 and bf16; in
    bf16 two calls must give the same bits, and the kernel is timed beside
    its twin, the card's bound, F.group_norm on the same x and the default
    chain. Prints a line each; returns the bf16 record."""
    from torch.nn.functional import group_norm

    from vdiff_tpu_torch.ops import groupnorm as G

    for dtype in (torch.float32, torch.bfloat16):
        x, gamma, beta, shift, scale, *_ = _fused_inputs(Bc, H, W, C, 1, dtype, gen, film, False)
        plan = G.gn_plan(H, W, C, groups, dtype)
        tag = (f"gn_film_silu_kernel B={Bc} {H}x{W} C={C} G={groups} film={film} silu={silu} "
               f"{str(dtype)[6:]} (plan: {plan.groups} groups, {plan.run_bytes} B a pixel, "
               f"cluster of {plan.ranks}, {plan.pixels} px a block, slab in "
               f"{plan.smem_bytes} B of shared memory)")
        ref = G.gn_film_silu_kernel_reference(
            x.float(), gamma, beta, None if shift is None else shift.float(),
            None if scale is None else scale.float(), num_groups=groups, apply_silu=silu)

        def kernel():
            return G.gn_film_silu_kernel(x, gamma, beta, shift, scale, num_groups=groups,
                                         apply_silu=silu)

        out = kernel()
        err = _check_fused(tag, out, ref, dtype)
        del ref
        if dtype == torch.float32:
            print(f"{phase}: {tag}: max_abs_err={err}", flush=True)
            continue
        if not torch.equal(out, kernel()):
            fail(f"{tag}: two calls gave different bits")
        del out
        # F.group_norm on the same x: the one form a single PyTorch call
        # computes (no FiLM, no SiLU), and the yardstick of every case
        nchw, g16, b16 = x.permute(0, 3, 1, 2), gamma.to(dtype), beta.to(dtype)
        group_norm_ms = cuda_ms(lambda: group_norm(nchw, groups, g16, b16, 1e-6))
        rec = {"max_abs_err": err, "ms": cuda_ms(kernel),
               "plain_ms": cuda_ms(lambda: G.gn_film_silu_kernel_reference(
                   x, gamma, beta, shift, scale, num_groups=groups, apply_silu=silu)),
               "library_ms": None if film or silu else group_norm_ms,
               **_gn_bound(Bc, H, W, C, dtype, film)}
        chain = cuda_ms(lambda: G.gn_film_silu(x, gamma, beta, shift, scale, num_groups=groups,
                                               apply_silu=silu, use_kernel=False))
        print(f"{phase}: {tag}: {_fmt(rec)} group_norm_ms={group_norm_ms} "
              f"default_chain_ms={chain} same_bits_twice=True", flush=True)
        return rec


def _conv_case(phase, gen, Bc, H, W, C, CO, film, skip, gn):
    """fused_gn_silu_conv3x3 (B11) at one shape vs its twin in f32 and bf16;
    in bf16 (the tensor-core conv of gn_silu_conv3x3_tc.cu) timed beside the
    FMA conv of gn_silu_conv3x3.cu on the same inputs (``before_ms``), its
    twin, the card's bound and cuDNN's bf16 conv alone (``conv_only_ms``;
    ``library_ms`` of the bare conv without a skip, the one form a single
    call computes). Prints a line each; returns the bf16 record."""
    from torch.nn.functional import conv2d

    from vdiff_tpu_torch.ops import conv3x3 as C3
    from vdiff_tpu_torch.ops import groupnorm as G

    for dtype in (torch.float32, torch.bfloat16):
        x, gamma, beta, shift, scale, w, bias, res = _fused_inputs(Bc, H, W, C, CO, dtype, gen,
                                                                   film, skip)
        if not gn:
            gamma = beta = None
        args = (x, w, bias, gamma, beta, shift, scale, res)
        tag = (f"fused_gn_silu_conv3x3 B={Bc} {H}x{W} {C}->{CO} gn={gn} film={film} "
               f"skip={skip} {str(dtype)[6:]}")
        flip = 0.0
        if gn and dtype == torch.bfloat16:
            y_max = G.gn_film_silu_kernel_reference(x, gamma, beta, shift, scale).abs().max()
            flip = FUSED_FLIP_RTOL * y_max.item() * w.abs().max().item()
        ref = C3.fused_gn_silu_conv3x3_reference_f32(*args)
        err = _check_fused(tag, C3.fused_gn_silu_conv3x3(*args), ref, dtype, flip)
        del ref
        if dtype == torch.float32:
            print(f"{phase}: {tag}: max_abs_err={err}", flush=True)
            continue
        # cuDNN's bf16 conv alone on the same x (channels_last), weights
        # and bias: the product without the prologue or the skip
        xc = x.permute(0, 3, 1, 2)
        wc = w.to(dtype).contiguous(memory_format=torch.channels_last)
        conv_only = cuda_ms(lambda: conv2d(xc, wc, bias.to(dtype), padding=1), iters=5, warmup=1)
        rec = {"max_abs_err": err,
               "ms": cuda_ms(lambda: C3.fused_gn_silu_conv3x3(*args), iters=5, warmup=1),
               "before_ms": cuda_ms(lambda: C3._launch_fma(*args, 32, 1e-6), iters=5, warmup=1),
               "plain_ms": cuda_ms(lambda: C3.fused_gn_silu_conv3x3_reference(*args), iters=5,
                                   warmup=1),
               # one PyTorch call computes the bare conv without a skip
               "library_ms": conv_only if not (gn or skip) else None,
               **_conv_bound(Bc, H, W, C, CO, dtype, gn, film, skip)}
        relayout = cuda_ms(lambda: w.permute(2, 3, 1, 0).reshape(9 * C, CO).to(dtype).contiguous())
        print(f"{phase}: {tag}: {_fmt(rec)} conv_only_ms={conv_only} "
              f"weight_relayout_ms={relayout} (inside ms; flip allowance {flip})", flush=True)
        return rec


def phase_fused_kernels():
    """gn_film_silu_kernel (B10) and fused_gn_silu_conv3x3 (B11) vs their
    twins, f32 and bf16, then timed in bf16 (_gn_case, _conv_case). Returns
    the per-kernel records: B10 at (64, 32, 32, 256) without FiLM or SiLU
    (the attention norm of up_1_us, the one form F.group_norm computes too),
    B11 at (64, 32, 32) 256->256 with FiLM and skip (conv2 of the level-0
    blocks)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    record = {}
    B = FUSED_B
    # (B, H, W, C, groups, film, silu): the CIFAR path's shapes, celeba's
    # 64x64 slabs (thread-block clusters of 8 and 16 blocks) and its 8x8 at
    # 1536 channels at B=32, then off the path groups of 6 on a non-square
    # image, groups of 42 (wider than a warp) and 4 groups of 6
    gn_cases = [(B, H, H, C, 32, False, silu) for H in (32, 16, 8) for C in (256, 512)
                for silu in (False, True)]
    gn_cases += [(B, 32, 32, 256, 32, True, True), (32, 64, 64, 192, 32, True, True),
                 (32, 64, 64, 384, 32, False, True), (32, 64, 64, 576, 32, False, True),
                 (32, 8, 8, 1536, 32, False, True), (3, 5, 7, 192, 32, True, True),
                 (2, 8, 8, 1344, 32, False, True), (2, 4, 6, 24, 4, True, True)]
    for Bc, H, W, C, groups, film, silu in gn_cases:
        rec = _gn_case("fused-kernels", gen, Bc, H, W, C, groups, film, silu)
        if (Bc, H, C, film, silu) == (B, 32, 256, False, False):
            record["gn_film_silu_kernel"] = rec

    # (B, H, W, C_in, C_out, film, skip, gn): conv1 and conv2 forms on the path
    conv_cases = [(B, H, H, 256, 256, film, film, True) for H in (32, 16, 8)
                  for film in (False, True)]
    # (celeba's 384- and 768-wide forms run in phase celeba-fused, on its path)
    conv_cases += [(B, 16, 16, 512, 256, False, False, True),  # C_in != C_out
                   (B, 16, 16, 256, 256, False, True, False),  # the bare conv (+ skip)
                   (B, 32, 32, 256, 256, False, False, False),  # the bare conv: one F.conv2d
                   (3, 5, 7, 192, 72, True, True, True),       # ragged tiles, groups of 6
                   (2, 9, 9, 32, 33, False, False, True)]
    for Bc, H, W, C, CO, film, skip, gn in conv_cases:
        rec = _conv_case("fused-kernels", gen, Bc, H, W, C, CO, film, skip, gn)
        if (Bc, H, C, film) == (B, 32, 256, True):
            record["fused_gn_silu_conv3x3"] = rec
    torch.cuda.empty_cache()
    return record


def _switches(conv, gn):
    """VDIFF_FUSED_CONV / VDIFF_FUSED_GN set for a block, restored after it."""
    from vdiff_tpu_torch.bench import switches

    return switches(VDIFF_FUSED_CONV=int(conv), VDIFF_FUSED_GN=int(gn))


def _fused_unet(phase, model, x, t, y, want_default, arms):
    """The bf16 ``model``'s forward with each arm's switches (name, conv,
    gn, launches) against the same forward with both off, within
    FUSED_UNET_RTOL of the output's scale, and each forward's launches."""

    def forward(conv, gn):
        with _switches(conv, gn), torch.inference_mode():
            _reset_counts()
            out = model(x, t, y)
            torch.cuda.synchronize()
            return out, _counts()

    base, launched = forward(False, False)
    if launched != want_default:
        fail(f"{phase}: the default forward launched {launched}")
    scale = base.abs().max().item()
    for name, conv, gn, want in arms:
        out, launched = forward(conv, gn)
        err = (out - base).abs().max().item()
        print(f"{phase}: full width B={x.shape[0]} bf16, {name} vs both off: max_abs_err={err} "
              f"(|out|max={scale}, limit {FUSED_UNET_RTOL * scale}: "
              f"{err / (FUSED_UNET_RTOL * scale)} of it), launches {_nonzero(launched)}",
              flush=True)
        if not bool(torch.isfinite(out).all()) or err > FUSED_UNET_RTOL * scale:
            fail(f"{phase}: {name}: max err {err} > {FUSED_UNET_RTOL} * {scale}")
        if launched != want:
            fail(f"{phase}: {name}: one forward launched {launched}, expected {want}")


def phase_fused_unet(cfg):
    """The full-width bf16 UNet at B=2: both switches on against both off,
    and the launch counts of one forward with both on and with GN alone."""
    model = _perturbed_unet(cfg, dtype=torch.bfloat16).cuda()
    gen = torch.Generator().manual_seed(7)
    x, t = torch.randn(2, 32, 32, 3, generator=gen).cuda(), torch.rand(2, generator=gen).cuda()
    _fused_unet("fused-unet", model, x, t, torch.tensor([3.0, 0.0]).cuda(),
                SAMPLE_FWD_LAUNCHES_BF16,
                (("both switches", True, True, FUSED_FWD_LAUNCHES),
                 ("VDIFF_FUSED_GN alone", False, True, FUSED_GN_FWD_LAUNCHES)))


def phase_fused_sample(ckpt, tmp, default_rate):
    """The generate CLI with the switches set in the environment for each run
    only: DDIM-256, w=0, B=64, one batch, bf16. Returns each run's launch
    counts: both switches (path cifar_sample_fused) and VDIFF_FUSED_GN alone."""
    from vdiff_tpu_torch import generate

    by_path = {}
    for path, name, conv, gn, per_fwd in (
            ("cifar_sample_fused", "VDIFF_FUSED_CONV=1 VDIFF_FUSED_GN=1", True, True,
             FUSED_FWD_LAUNCHES),
            ("cifar_sample_fused_gn", "VDIFF_FUSED_GN=1", False, True, FUSED_GN_FWD_LAUNCHES)):
        with _switches(conv, gn):
            _reset_counts()
            summary = generate.main([
                "--config-path", CONFIG, "--ckpt-path", ckpt, "--save-dir",
                os.path.join(tmp, path), "--use-ema", "--use-ddim", "--allow-bf16",
                "--sample-timesteps", str(STEPS), "--w-guide", "0", "--batch-size", str(FUSED_B),
                "--total-size", str(FUSED_B), "--seed", "0",
            ])
            launched = _device_launches(f"fused-sample: {name}", _counts(), summary["stats"],
                                        per_fwd, STEPS)
        pngs = len(glob.glob(os.path.join(summary["save_dir"], "*.png")))
        print(f"fused-sample: {name} w=0 B={FUSED_B}, {STEPS} DDIM steps, finite="
              f"{summary['finite']}, {pngs} PNGs", flush=True)
        print(f"fused-sample: {name}: {summary['images'] / summary['seconds']} samples/s against "
              f"{default_rate} samples/s of the default path (sample phase, w=0 B=64, two batches)",
              flush=True)
        if pngs != FUSED_B or not summary["finite"]:
            fail(f"fused-sample {name}: {pngs} PNGs (want {FUSED_B}), finite={summary['finite']}")
        by_path[path] = launched
    return by_path


def phase_celeba_kernels():
    """attn_fwd_pack1 (B6), attn_fwd_pack1_lse (B7), attn_bwd_pack1 (B8) and
    attn_bwd_pack1_kv (B9) at CELEBA_KERNEL_SHAPES, f32 and bf16, against
    their twins: on the whole batch at T <= TWIN_FULL_BATCH_MAX_T, else on
    batch slices 0, 1, B-2, B-1 of the same inputs and of the kernels'
    outputs. B9 takes B7's own (out, lse), its twin their slices. In bf16
    all four run the tensor-core kernels: B6's and B7's outputs are held by
    _check_tc_fwd's P·|v| limit (B7's lse within LSE_ATOL as in f32), B8's and
    B9's d(qkv) by the bf16 backward limit. In f32 B6 and B7 run
    attn_fwd_tf32.cu and its lse entry, held by _check_f32_fwd on the same
    slices (B7's lse also against the f64 twin's). Each kernel is then timed
    on the whole batch beside its twin, SDPA, the card's bound and the
    f32-FMA kernel it replaced on the same inputs (``before_ms``), in both
    dtypes. In f32 B8 and B9 run attn_bwd_tf32.cu, held by _check_f32_bwd
    (the f64 twin beside the FMA kernels' error). Returns the per-kernel
    records in bf16 (each kernel's first shape; max_abs_err the largest over
    its bf16 shapes) and the f32 records of the celeba f32 train step's B7,
    B8 and B9 (F32_CELEBA_RECORDS, every shape under "shapes"; B6's f32
    record is phase 10b's)."""
    from vdiff_tpu_torch.ops import attention as A

    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(2)
    C = 64
    worst = collections.defaultdict(float)
    record = {}
    for B, T, N, names in CELEBA_KERNEL_SHAPES:
        idx = list(range(B)) if T <= TWIN_FULL_BATCH_MAX_T else [0, 1, B - 2, B - 1]
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"B={B} T={T} N={N} C={C} {str(dtype)[6:]}"
            on = "" if len(idx) == B else f" (twin on batch slices {idx})"
            qkv = torch.randn(B, T, 3 * N * C, device="cuda", generator=gen).to(dtype)
            g = torch.randn(B, T, N * C, device="cuda", generator=gen).to(dtype)
            sq, sg = qkv[idx], g[idx]
            errs, timed = {}, {}
            # (kernel, twin, library, bound kind, the FMA kernel it replaced
            # or None) of each wrapper to time
            if "attn_fwd_pack1" in names:
                label, got = f"attn_fwd_pack1 {tag}{on}", A.attn_fwd_pack1(qkv, N)[idx]
                if dtype == torch.bfloat16:
                    errs["attn_fwd_pack1"] = _check_tc_fwd(label, got, sq, N)
                else:
                    ref_out, _ = A.attention_qkv_lse_reference(sq.float(), N)
                    errs["attn_fwd_pack1"] = _check_f32_fwd(
                        label, got, sq, N, fma_fwd_online(qkv, N)[idx], ref_out)["max_abs_err"]
                    del ref_out
                del got
                timed["attn_fwd_pack1"] = (lambda: A.attn_fwd_pack1(qkv, N),
                                           lambda: A.attention_qkv_lse_reference(qkv, N),
                                           _sdpa(qkv, N), "fwd", lambda: fma_fwd_online(qkv, N))
            if "attn_fwd_pack1_lse" in names:
                ref_out, ref_lse = A.attention_qkv_lse_reference(sq.float(), N)
                out, lse = A.attn_fwd_pack1_lse(qkv, N)
                label = f"attn_fwd_pack1_lse {tag}{on}"
                if dtype == torch.bfloat16:
                    errs["attn_fwd_pack1_lse"] = _check_tc_fwd(label, out[idx], sq, N)
                else:
                    fma_out, fma_lse = fma_fwd_lse(qkv, N)
                    errs["attn_fwd_pack1_lse"] = _check_f32_fwd(
                        label, out[idx], sq, N, fma_out[idx], ref_out, lse[idx], fma_lse[idx])
                    del fma_out, fma_lse
                lse_err = (lse[idx] - ref_lse).abs().max().item()
                if lse.shape != (B, N, T) or not lse_err <= LSE_ATOL:
                    fail(f"attn_fwd_pack1_lse {tag}: lse {tuple(lse.shape)} max err {lse_err}")
                print(f"celeba-kernels: attn_fwd_pack1_lse {tag}: lse max_abs_err {lse_err}",
                      flush=True)
                timed["attn_fwd_pack1_lse"] = (lambda: A.attn_fwd_pack1_lse(qkv, N),
                                               lambda: A.attention_qkv_lse_reference(qkv, N),
                                               _sdpa(qkv, N), "fwd_lse",
                                               lambda: fma_fwd_lse(qkv, N))
                del ref_out, ref_lse
            if "attn_bwd_pack1" in names:
                label, got = f"attn_bwd_pack1 {tag}{on}", A.attn_bwd_pack1(qkv, g, N)[idx]
                ref = A.attention_qkv_bwd_reference(sq, sg, N)
                errs["attn_bwd_pack1"] = (
                    _check_bwd(label, got, ref, dtype) if dtype == torch.bfloat16 else
                    _check_f32_bwd(label, got, ref, sq, sg, N, fma_bwd(qkv, g, N)[idx]))
                del got, ref
                timed["attn_bwd_pack1"] = (lambda: A.attn_bwd_pack1(qkv, g, N),
                                           lambda: A.attention_qkv_bwd_reference(qkv, g, N),
                                           _sdpa(qkv, N, g), "bwd", lambda: fma_bwd(qkv, g, N))
            if "attn_bwd_pack1_kv" in names:
                label = f"attn_bwd_pack1_kv {tag}{on}"
                got = A.attn_bwd_pack1_kv(qkv, out, lse, g, N)[idx]
                ref = A.attention_qkv_bwd_kv_reference(sq, out[idx], lse[idx], sg, N)
                errs["attn_bwd_pack1_kv"] = (
                    _check_bwd(label, got, ref, dtype) if dtype == torch.bfloat16 else
                    _check_f32_bwd(label, got, ref, sq, sg, N,
                                   fma_bwd_kv(qkv, out, lse, g, N)[idx]))
                del got, ref
                timed["attn_bwd_pack1_kv"] = (
                    lambda: A.attn_bwd_pack1_kv(qkv, out, lse, g, N),
                    lambda: A.attention_qkv_bwd_kv_reference(qkv, out, lse, g, N),
                    _sdpa(qkv, N, g), "bwd_kv", lambda: fma_bwd_kv(qkv, out, lse, g, N))
            print(f"celeba-kernels: {tag}{on}: max_abs_err {errs}", flush=True)
            del sq, sg
            torch.cuda.empty_cache()
            bf16 = dtype == torch.bfloat16
            for name, (fn, plain, library, kind, before) in timed.items():
                if bf16:
                    worst[name] = max(worst[name], errs[name])
                rec = {"ms": cuda_ms(fn, iters=3, warmup=1),
                       "before_ms": cuda_ms(before, iters=3, warmup=1),
                       "plain_ms": cuda_ms(plain, iters=3, warmup=1),
                       "library_ms": cuda_ms(library, iters=3, warmup=1),
                       **_bound(kind, B, T, N, C, dtype)}
                print(f"celeba-kernels: {name} {tag}: " + _fmt(rec)
                      + (" (library: SDPA forward+backward)" if "bwd" in name else ""),
                      flush=True)
                if bf16:
                    record.setdefault(name, rec)
                elif name in F32_CELEBA_RECORDS:  # the celeba f32 train step's kernels
                    _keep_shape(record, F32_CELEBA_RECORDS[name], (B, T, N, C),
                                {**errs[name], **rec})
                torch.cuda.empty_cache()
            del qkv, g, timed
            out = lse = None
            torch.cuda.empty_cache()
    for name, rec in record.items():
        if name in worst:
            record[name] = {"max_abs_err": worst[name], **rec}
    return record


def _celeba_inputs(B, gen):
    """x in [-1, 1] (B, 64, 64, 3) and multi-hot tags (B, 40), bench.py's draw."""
    x = torch.rand(B, 64, 64, 3, generator=gen) * 2 - 1
    return x, (torch.rand(B, 40, generator=gen) < 0.5).float()


def phase_celeba_unet(cfg):
    model = _perturbed_unet(dict(cfg, model=dict(cfg["model"], drop_rate=0.0)), num_classes=40,
                            multitags=True)
    print(f"celeba-unet: {sum(p.numel() for p in model.parameters())} parameters", flush=True)
    x, y = _celeba_inputs(1, torch.Generator().manual_seed(8))
    _unet_parity("celeba-unet", model, x, torch.rand(1, generator=torch.Generator().manual_seed(9)),
                 y, CELEBA_FWD_LAUNCHES)
    return model


def phase_celeba_train_unet(cfg, model):
    """One full-width f32 train step of the celeba model at B=1, dropout off."""
    x, y = _celeba_inputs(1, torch.Generator().manual_seed(13))
    _train_step_parity("celeba-train-unet", cfg, model, x, y, torch.tensor([True]),
                       CELEBA_STEP_LAUNCHES)


def _write_attr_table(root, rows, seed=5):
    """A CelebA attribute table (and its split list) of ``rows`` seeded ±1 rows
    under ``root/celeba``: the tags the generate CLI draws."""
    base = os.path.join(root, "celeba")
    os.makedirs(base, exist_ok=True)
    gen = torch.Generator().manual_seed(seed)
    attrs = torch.randint(0, 2, (rows, 40), generator=gen) * 2 - 1
    names = [f"{i + 1:06d}.jpg" for i in range(rows)]
    with open(os.path.join(base, "list_attr_celeba.txt"), "w") as f:
        f.write(f"{rows}\n" + " ".join(f"attr_{k}" for k in range(40)) + "\n")
        for name, row in zip(names, attrs.tolist()):
            f.write(name + "  " + " ".join(str(v) for v in row) + "\n")
    with open(os.path.join(base, "list_eval_partition.txt"), "w") as f:
        f.writelines(f"{name} 0\n" for name in names)


def phase_celeba_sample(model, tmp):
    """The generate CLI on celeba.json (bf16, B=32, CELEBA_STEPS DDIM steps at
    w=0, tags from a written attribute table) with both fused switches off,
    then with both on (VDIFF_FUSED_CONV=1 VDIFF_FUSED_GN=1, set for that run
    only); returns each run's launches (paths celeba_sample and
    celeba_fused_sample)."""
    from vdiff_tpu_torch import generate

    ckpt = os.path.join(tmp, "celeba.pt")
    sd = model.state_dict()
    torch.save({"model": sd, "ema": {"shadow": sd}}, ckpt)
    data_root = os.path.join(tmp, "celeba_data")
    _write_attr_table(data_root, rows=64)
    B = CELEBA_SAMPLE_B
    by_path, rates = {}, {}
    for path, name, on, per_fwd in (
            ("celeba_sample", "switches off", False, CELEBA_FWD_LAUNCHES_BF16),
            ("celeba_fused_sample", "VDIFF_FUSED_CONV=1 VDIFF_FUSED_GN=1", True,
             CELEBA_FUSED_FWD_LAUNCHES)):
        with _switches(on, on):
            _reset_counts()
            summary = generate.main([
                "--config-path", CELEBA_CONFIG, "--ckpt-path", ckpt, "--data-root", data_root,
                "--save-dir", os.path.join(tmp, f"{path}_out"), "--use-ema", "--use-ddim",
                "--allow-bf16", "--sample-timesteps", str(CELEBA_STEPS), "--w-guide", "0",
                "--batch-size", str(B), "--total-size", str(B), "--seed", "0",
            ])
            by_path[path] = _device_launches(f"celeba-sample: {name}", _counts(),
                                             summary["stats"], per_fwd, CELEBA_STEPS)
        pngs = len(glob.glob(os.path.join(summary["save_dir"], "*.png")))
        rates[path] = summary["images"] / summary["seconds"]
        print(f"celeba-sample: {name}, w=0 B={B}, {CELEBA_STEPS} DDIM steps bf16: "
              f"{rates[path]} samples/s ({summary['seconds']} s, the first batch's warm-up "
              f"included), {pngs} PNGs, finite={summary['finite']}", flush=True)
        if pngs != B or not summary["finite"]:
            fail(f"celeba-sample {name}: {pngs} PNGs (want {B}), finite={summary['finite']}")
    print(f"celeba-sample: both switches {rates['celeba_fused_sample']} samples/s against "
          f"{rates['celeba_sample']} with both off (one batch each, its warm-up included; the "
          "bench phase's celeba _fused_gn line follows)", flush=True)
    return by_path


def phase_celeba_train(cfg):
    """CELEBA_TRAIN_STEPS bf16 train steps of the celeba model at B=48 (the
    JAX bench's batch, no remat), dropout as configured; returns the launch
    counts summed over the steps."""
    from vdiff_tpu_torch.factory import build_diffusion, build_unet
    from vdiff_tpu_torch.train_lib import Optimizer, make_train_step

    torch.cuda.empty_cache()
    tr, cond = cfg["train"], cfg["conditional"]
    model = build_unet(cfg["model"], in_channels=3, model_out_type=cfg["diffusion"]["model_out_type"],
                       num_classes=40, multitags=True, dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(0)).cuda()
    ema = copy.deepcopy(model).requires_grad_(False)
    diffusion, timesteps = build_diffusion(cfg["diffusion"], w_guide=cond["w_guide"],
                                           p_uncond=cond["p_uncond"])
    opt = Optimizer(model.parameters(), lr=tr["lr"], weight_decay=tr["weight_decay"],
                    warmup=tr["warmup"], grad_norm=tr["grad_norm"])
    step = make_train_step(model, diffusion, opt, timesteps, use_cfg=True,
                           ema_decay=tr["ema_decay"], ema_model=ema)
    x, y = (a.cuda() for a in _celeba_inputs(CELEBA_TRAIN_B, torch.Generator().manual_seed(14)))
    torch.cuda.reset_peak_memory_stats()
    total = collections.Counter()
    for i in range(CELEBA_TRAIN_STEPS):
        _reset_counts()
        t0 = time.perf_counter()
        loss = step(x, y, 0, i).item()
        seconds = time.perf_counter() - t0
        launched = _counts()
        print(f"celeba-train: bf16 B={CELEBA_TRAIN_B} step {i}: {seconds:.3f} s "
              f"({CELEBA_TRAIN_B / seconds:.1f} img/s), loss {loss}, launches {launched}", flush=True)
        if not math.isfinite(loss):
            fail(f"celeba-train: step {i} loss {loss}")
        if launched != CELEBA_STEP_LAUNCHES_BF16:
            fail(f"celeba-train: step {i} launched {launched}, expected "
                 f"{CELEBA_STEP_LAUNCHES_BF16}")
        total.update(launched)
    print(f"celeba-train: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    return total



def phase_train_f32(cfg, cifar_img_per_s):
    """The default (f32) train steps at full width. CIFAR's is the gate's
    train stage (phase 4i: the train CLI on synthetic_flagship.json without
    --allow-bf16 at B=128), whose img/s after the first step is passed in.
    celeba's: CELEBA_TRAIN_STEPS f32 train steps of the celeba model at
    CELEBA_TRAIN_B through make_train_step (the train CLI's step), seeded
    images and tags, after one warm-up step: ms a step (CUDA events), a
    finite loss and CELEBA_STEP_LAUNCHES a step (B8 and B9 on
    attn_bwd_tf32.cu). Returns the timed steps' launches under the f32
    kernels' JSON names (path celeba_train_f32)."""
    from vdiff_tpu_torch.factory import build_diffusion, build_unet
    from vdiff_tpu_torch.train_lib import Optimizer, make_train_step

    torch.cuda.empty_cache()
    tr, cond = cfg["train"], cfg["conditional"]
    model = build_unet(cfg["model"], in_channels=3, model_out_type=cfg["diffusion"]["model_out_type"],
                       num_classes=40, multitags=True, generator=torch.Generator().manual_seed(0)).cuda()
    ema = copy.deepcopy(model).requires_grad_(False)
    diffusion, timesteps = build_diffusion(cfg["diffusion"], w_guide=cond["w_guide"],
                                           p_uncond=cond["p_uncond"])
    opt = Optimizer(model.parameters(), lr=tr["lr"], weight_decay=tr["weight_decay"],
                    warmup=tr["warmup"], grad_norm=tr["grad_norm"])
    step = make_train_step(model, diffusion, opt, timesteps, use_cfg=True,
                           ema_decay=tr["ema_decay"], ema_model=ema)
    x, y = (a.cuda() for a in _celeba_inputs(CELEBA_TRAIN_B, torch.Generator().manual_seed(15)))
    torch.cuda.reset_peak_memory_stats()
    step(x, y, 0, 0).item()  # warm-up
    total = collections.Counter()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ms = []
    for i in range(1, CELEBA_TRAIN_STEPS + 1):
        _reset_counts()
        start.record()
        loss = step(x, y, 0, i).item()
        end.record()
        end.synchronize()
        launched = _counts()
        ms.append(start.elapsed_time(end))
        print(f"train-f32: celeba f32 B={CELEBA_TRAIN_B} step {i}: {ms[-1]} ms, loss {loss}",
              flush=True)
        if not math.isfinite(loss):
            fail(f"train-f32: celeba step {i} loss {loss}")
        if launched != CELEBA_STEP_LAUNCHES:
            fail(f"train-f32: celeba step {i} launched {launched}, expected {CELEBA_STEP_LAUNCHES}")
        total.update(launched)
    step_ms = sum(ms) / len(ms)
    print(f"train-f32: the default f32 train steps (TF32 off; {torch.cuda.get_device_name(0)}): "
          f"CIFAR synthetic_flagship B=128 through the train CLI (the gate's train stage) "
          f"{cifar_img_per_s} img/s; celeba B={CELEBA_TRAIN_B} {step_ms} ms a step "
          f"({CELEBA_TRAIN_B * 1e3 / step_ms} img/s), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del model, ema, opt, step
    torch.cuda.empty_cache()
    return _f32_path(total)


def _write_mnist(root, n, seed=6):
    """MNIST's train idx pair in torchvision's raw layout under ``root``
    (``MNIST/raw``, where data.py::load_mnist looks): ``n`` seeded 28x28
    digits and their labels 0-9."""
    base = os.path.join(root, "MNIST", "raw")
    os.makedirs(base, exist_ok=True)
    rng = np.random.RandomState(seed)
    with open(os.path.join(base, "train-images-idx3-ubyte"), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28)
                + rng.randint(0, 256, (n, 28, 28), dtype=np.uint8).tobytes())
    with open(os.path.join(base, "train-labels-idx1-ubyte"), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + rng.randint(0, 10, n).astype(np.uint8).tobytes())


def phase_mnist(tmp):
    """mnist.json at full width (one input channel, heads of 128): (a) the f32
    UNet on CUDA against the CPU at B=2 with MNIST_FWD_LAUNCHES; (d) the bf16
    UNet with both fused switches against both off; (e) B10 and B11 at every
    shape of mnist's fused forward (MNIST_GN_SHAPES, MNIST_CONV_SHAPES) at
    the CFG-doubled sampling batch, against their twins; (b) the train CLI,
    bf16, on a written idx tree of MNIST_DIGITS digits (4 steps of 128),
    MNIST_STEP_LAUNCHES_BF16 a step; (c) the generate CLI's defaults from its
    ckpt_last.pt (ancestral, CFG w=0.1), MNIST_SAMPLE_STEPS steps at B=64:
    greyscale 32x32 PNGs. Returns each CLI run's launches and the B10/B11
    shapes' records."""
    from vdiff_tpu_torch import generate, train
    from vdiff_tpu_torch.factory import load_experiment_config

    cfg, _ = load_experiment_config(MNIST_CONFIG)
    model = _perturbed_unet(dict(cfg, model=dict(cfg["model"], drop_rate=0.0)), in_channels=1)
    print(f"mnist: {sum(p.numel() for p in model.parameters())} parameters", flush=True)
    gen = torch.Generator().manual_seed(40)
    x, t = torch.randn(2, 32, 32, 1, generator=gen), torch.rand(2, generator=gen)
    y = torch.tensor([3.0, 0.0])
    _unet_parity("mnist: unet", model, x, t, y, MNIST_FWD_LAUNCHES)
    del model
    bf16 = _perturbed_unet(cfg, dtype=torch.bfloat16, in_channels=1).cuda()
    _fused_unet("mnist: fused-unet", bf16, x.cuda(), t.cuda(), y.cuda(), MNIST_FWD_LAUNCHES_BF16,
                (("both switches", True, True, MNIST_FUSED_FWD_LAUNCHES),))
    del bf16
    kgen = torch.Generator(device="cuda").manual_seed(41)
    B = 2 * MNIST_SAMPLE_B
    shapes = {"gn_film_silu_kernel": [], "fused_gn_silu_conv3x3": []}
    for H, W, C, film, silu in MNIST_GN_SHAPES:
        rec = _gn_case("mnist: fused-kernels", kgen, B, H, W, C, 32, film, silu)
        shapes["gn_film_silu_kernel"].append(dict(B=B, H=H, W=W, C=C, film=film, silu=silu, **rec))
    for H, W, C, CO, film, skip, gn in MNIST_CONV_SHAPES:
        rec = _conv_case("mnist: fused-kernels", kgen, B, H, W, C, CO, film, skip, gn)
        shapes["fused_gn_silu_conv3x3"].append(dict(B=B, H=H, W=W, C=C, CO=CO, film=film,
                                                    skip=skip, gn=gn, **rec))
    torch.cuda.empty_cache()

    data_root = os.path.join(tmp, "mnist_data")
    _write_mnist(data_root, MNIST_DIGITS)
    _reset_counts()
    t0 = time.perf_counter()
    summary = train.main(["--config-path", MNIST_CONFIG, "--allow-bf16", "--epochs", "1",
                          "--batch-size", str(MNIST_TRAIN_B), "--num-save-images", "0",
                          "--data_root", data_root, "--exp-dir", os.path.join(tmp, "exps_mnist")])
    seconds = time.perf_counter() - t0
    trained = _counts()
    # the train CLI turns cuDNN's autotuner on (defaults.json); the sampler
    # runs without it, as the generate CLI does
    torch.backends.cudnn.benchmark = False
    steps = summary["steps"]
    ckpt = os.path.join(summary["ckpt_dir"], "ckpt_last.pt")
    print(f"mnist: train CLI bf16 B={MNIST_TRAIN_B} on {MNIST_DIGITS} written digits, {steps} "
          f"steps, loss {summary['loss']}, {summary['img_per_s']} img/s over the steps after the "
          f"first, {seconds:.1f} s with the checkpoint, launches {_nonzero(trained)}", flush=True)
    if steps != MNIST_DIGITS // MNIST_TRAIN_B or summary["loss"] is None or \
            not math.isfinite(summary["loss"]) or not os.path.exists(ckpt):
        fail(f"mnist: train CLI {steps} steps, loss {summary['loss']}, ckpt_last.pt "
             f"{os.path.exists(ckpt)}")
    want = {k: v * steps for k, v in MNIST_STEP_LAUNCHES_BF16.items()}
    if trained != want:
        fail(f"mnist: train CLI launches {trained}, expected {want}")

    _reset_counts()
    summary = generate.main([
        "--config-path", MNIST_CONFIG, "--ckpt-path", ckpt, "--save-dir",
        os.path.join(tmp, "mnist_out"), "--use-ema", "--allow-bf16", "--sample-timesteps",
        str(MNIST_SAMPLE_STEPS), "--batch-size", str(MNIST_SAMPLE_B), "--total-size",
        str(MNIST_SAMPLE_B), "--seed", "0"])
    sampled = _device_launches("mnist: sample", _counts(), summary["stats"],
                               MNIST_FWD_LAUNCHES_BF16, MNIST_SAMPLE_STEPS)
    pngs = glob.glob(os.path.join(summary["save_dir"], "*.png"))
    heads = {_png_header(f) for f in pngs}
    print(f"mnist: generate (ancestral, w=0.1) B={MNIST_SAMPLE_B}, {MNIST_SAMPLE_STEPS} steps bf16 "
          f"from ckpt_last.pt: {summary['images'] / summary['seconds']} samples/s (the warm-up "
          f"included), {len(pngs)} PNGs of {heads} (width, height, colour type), "
          f"finite={summary['finite']}", flush=True)
    if len(pngs) != MNIST_SAMPLE_B or heads != {(32, 32, 0)} or not summary["finite"]:
        fail(f"mnist: generate gave {len(pngs)} PNGs of {heads}, finite={summary['finite']}")
    return {"mnist_train": trained, "mnist_sample": sampled}, shapes


def phase_uncond():
    """cifar10_uncond.json at full width (x0 output, snr_trunc, no labels):
    (a) the f32 UNet on CUDA against the CPU at B=2; (b) one f32 train step
    on CUDA against the CPU; (c) GRAPH_STEPS bf16 steps at B=64, graph
    against eager, DDIM and ancestral. Returns (c)'s graph runs' launches."""
    from vdiff_tpu_torch.factory import load_experiment_config

    cfg, _ = load_experiment_config(UNCOND_CONFIG)
    model = _perturbed_unet(dict(cfg, model=dict(cfg["model"], drop_rate=0.0)), num_classes=0)
    gen = torch.Generator().manual_seed(42)
    x, t = torch.randn(2, 32, 32, 3, generator=gen), torch.rand(2, generator=gen)
    _unet_parity("uncond: unet", model, x, t, None, _launches(attn_fwd_online=ONLINE_PER_FWD,
                                                              attn_fwd_qblk=QBLK_PER_FWD))
    x_0 = torch.rand(2, 32, 32, 3, generator=gen) * 2 - 1
    _train_step_parity("uncond: train-unet", cfg, model, x_0, None, None, TRAIN_STEP_LAUNCHES)
    del model
    bf16 = _perturbed_unet(cfg, num_classes=0, dtype=torch.bfloat16).cuda()
    cgen = torch.Generator(device="cuda").manual_seed(43)
    by_path = {}
    for ddim in (True, False):
        x_T = torch.randn(FUSED_B, 32, 32, 3, device="cuda", generator=cgen)
        by_path["uncond_graph_" + ("ddim" if ddim else "ancestral")] = _graph_vs_eager(
            f"cifar10_uncond B={FUSED_B}", bf16, cfg, 0.0, x_T, None, GRAPH_STEPS,
            SAMPLE_FWD_LAUNCHES_BF16, use_ddim=ddim)
    del bf16
    torch.cuda.empty_cache()
    return by_path


def phase_learned(cfg):
    """cifar10_cond's widths with model_var_type="learned" (2·3 outputs, the
    second half a variance logit) and loss_type="kl": (a) one f32 train step
    on CUDA against the CPU; (b) calc_all_bpd at B=2, T=8 on CUDA against the
    CPU (the nll bound); (c) GRAPH_STEPS bf16 ancestral steps at CFG w=0.1
    B=32, graph against eager, which replays the interpolated log-variance.
    Returns (b)'s and (c)'s launches."""
    cfg = dict(cfg, diffusion=dict(cfg["diffusion"], model_var_type="learned", loss_type="kl"))
    model = _perturbed_unet(dict(cfg, model=dict(cfg["model"], drop_rate=0.0)))
    gen = torch.Generator().manual_seed(44)
    x_0 = torch.randint(0, 256, (2, 32, 32, 3), generator=gen).float() / 127.5 - 1.0
    _train_step_parity("learned: train-unet (kl loss)", cfg, model, x_0, torch.tensor([3, 7]),
                       torch.tensor([True, False]), TRAIN_STEP_LAUNCHES)
    by_path = {"learned_nll": _bpd_parity("learned: nll", cfg, model)}
    del model
    bf16 = _perturbed_unet(cfg, dtype=torch.bfloat16).cuda()
    B = 32
    x_T = torch.randn(B, 32, 32, 3, device="cuda", generator=torch.Generator(device="cuda").manual_seed(45))
    y = (torch.arange(B, device="cuda") % 10 + 1).float()
    by_path["learned_graph_ancestral"] = _graph_vs_eager(
        f"cifar10_cond learned variance w=0.1 B={B}", bf16, cfg, 0.1, x_T, y, GRAPH_STEPS,
        SAMPLE_FWD_LAUNCHES_BF16, use_ddim=False)
    del bf16
    torch.cuda.empty_cache()
    return by_path


def phase_remat(cfg, card):
    """One celeba bf16 train step at B=48 in each checkpointing mode, same
    weights, draws and step generator (dropout as configured), under cuDNN's
    deterministic algorithms, and a second step without remat as the control:
    the losses equal bit for bit, the gradients bit for bit where the
    control's are (else within REMAT_GRAD_SPREAD of the control's spread);
    then, with the default algorithms, a warm-up step and REMAT_TIMED_STEPS
    timed steps of each, with their peak memory."""
    from vdiff_tpu_torch.factory import build_diffusion, build_unet
    from vdiff_tpu_torch.train_lib import Optimizer, make_train_step

    torch.cuda.empty_cache()
    tr, cond = cfg["train"], cfg["conditional"]
    diffusion, timesteps = build_diffusion(cfg["diffusion"], w_guide=cond["w_guide"],
                                           p_uncond=cond["p_uncond"])
    kw = dict(in_channels=3, model_out_type=cfg["diffusion"]["model_out_type"], num_classes=40,
              multitags=True, dtype=torch.bfloat16)
    weights = build_unet(cfg["model"], generator=torch.Generator().manual_seed(0),
                         **kw).state_dict()
    B = CELEBA_TRAIN_B
    gen = torch.Generator().manual_seed(15)
    x, y = (a.cuda() for a in _celeba_inputs(B, gen))
    draws = [{"t": torch.rand(B, generator=gen).cuda(),
              "noise": torch.randn(x.shape, generator=gen).cuda(),
              "keep": (torch.rand(B, generator=gen) > cond["p_uncond"]).cuda()}]

    def first_step(flags):
        """A new model and optimizer from ``weights`` and their first step
        under the deterministic algorithms: (step, loss, grads, launches)."""
        model = build_unet(cfg["model"], **kw, **flags)
        model.load_state_dict(weights)
        model.cuda()
        opt = Optimizer(model.parameters(), lr=tr["lr"], weight_decay=tr["weight_decay"],
                        warmup=tr["warmup"], grad_norm=tr["grad_norm"])
        step = make_train_step(model, diffusion, opt, timesteps, use_cfg=True)
        torch.backends.cudnn.deterministic = True
        try:
            _reset_counts()
            loss = step(x, y, 0, 0, draws=draws).item()
            launched = _counts()
        finally:
            torch.backends.cudnn.deterministic = False
        grads = torch.cat([p.grad.flatten().cpu() for p in model.parameters()])
        return step, loss, grads, launched

    _, loss, grads, _ = first_step({})
    scale = grads.abs().max().item()
    torch.cuda.empty_cache()
    runs = {}
    for mode, flags in REMAT_MODES.items():
        step, got_loss, got, launched = first_step(flags)
        # the default algorithms' first use (cuDNN's heuristics, lazy
        # loads) falls in an untimed step
        step(x, y, 0, 1, draws=draws)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(REMAT_TIMED_STEPS):
            step(x, y, 0, 2 + i, draws=draws)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / REMAT_TIMED_STEPS
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs[mode] = (got_loss, got, peak)
        print(f"remat: {card}: celeba bf16 B={B} {mode}: loss {got_loss}, step {ms:.2f} ms (CUDA "
              f"events, mean of {REMAT_TIMED_STEPS} steps after a warm-up), peak device memory "
              f"{peak:.3f} GiB, launches {_nonzero(launched)}", flush=True)
        want = CELEBA_STEP_LAUNCHES_BF16 if mode == "none" else CELEBA_STEP_LAUNCHES_BF16_REMAT
        if not math.isfinite(got_loss) or launched != want:
            fail(f"remat: {mode}: loss {got_loss}, launches {launched}, expected {want}")
        del step
        torch.cuda.empty_cache()
    # the control: the no-remat step against the one before it
    spread = (runs["none"][1] - grads).abs().max().item() / scale
    exact = spread == 0.0 and runs["none"][0] == loss
    print(f"remat: {card}: control, none vs none: loss "
          f"{'equal' if runs['none'][0] == loss else 'DIFFERS'} bit for bit, gradients "
          f"{'equal bit for bit' if exact else f'max err {spread} of the largest'}", flush=True)
    for mode in ("full", "conv"):
        got_loss, got, _ = runs[mode]
        err = (got - grads).abs().max().item() / scale
        bound = 0.0 if exact else REMAT_GRAD_SPREAD * spread
        print(f"remat: {card}: {mode} vs none: loss {'equal' if got_loss == loss else 'DIFFERS'} "
              f"bit for bit, gradients {'equal bit for bit' if err == 0.0 else 'not bit for bit'} "
              f"(max err {err} of the largest, bound {bound}: "
              f"{'bit for bit, as the control' if exact else 'the control spread'})", flush=True)
        if got_loss != loss or err > bound:
            fail(f"remat: {mode}: loss {got_loss} vs {loss}, gradient err {err} > {bound}")
    peaks = {mode: run[2] for mode, run in runs.items()}
    if not peaks["full"] < peaks["conv"] < peaks["none"]:
        fail(f"remat: peak memory {peaks} (GiB) does not order full < conv < none")


# ---------------------------------------------------------------------------
# the multi-GPU paths under torchrun
# ---------------------------------------------------------------------------

# the dist phase: the port's CLIs on this card under torchrun. The train runs
# take synthetic_flagship's 512 images in DIST_TRAIN_STEPS steps of 128,
# dropout off, no sample grid, cuDNN's autotuner off (defaults.json turns it
# on), so that the plain, DDP and FSDP runs pick the same algorithms; the
# generate runs DIST_SAMPLE_STEPS DDIM steps at w=0 in two batches of 64. A
# process takes ~9 s to import torch and reach the card (an NVIDIA H100 80GB
# HBM3 at 700 W), torchrun's agent about as much again, so one torchrun
# launch runs every CLI call that parts (a)-(c) compare and a second the two
# gloo ranks of part (d). In the first (dist_clis_worker) the plain runs go
# first, in a fresh process whose cuDNN has tuned nothing: run in this
# process after phase 7's autotuned train CLI, the plain run was not the DDP
# run bit for bit.
DIST_TRAIN_STEPS, DIST_SAMPLE_STEPS = 4, 32
DIST_TIMEOUT = 300
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
# the 2-rank DDP step over gloo with CUDA tensors (part d): f32, B=4 global,
# against the one-rank step on the global batch, within the f32 step bounds
GLOO_B = 4
# FSDP at one rank against the plain run (DDP must be bit for bit): the
# losses within FSDP_LOSS_RTOL of themselves, the params and EMA within
# FSDP_PARAM_RTOL of their largest. FSDP2 routes each block's inputs through
# one autograd node (its post-backward hook), and the backward then sums the
# gradient of a tensor that several ops read (the embedding every res block
# reads, a down block's input that its branches and the skip list read) in
# another order. scripts/probe_torch_fsdp_parity.py isolates it (an NVIDIA
# H100 80GB HBM3 at 700 W): the plain run with those identity nodes alone
# equals FSDP bit for bit; the conv and linear calls see the same layouts;
# the clip is not it (its norm is equal where the gradients first differ,
# and with the clip off they differ alike). Steps 0-1 are bit for bit, step
# 2's down-path and embedding gradients 3.8e-8 of the largest apart; after
# 4 steps the losses are equal and the params 2.98e-8 of the largest apart.
# The order comes from the graph, not from the weights' layout or the rank
# count; more ranks add the reduce-scatter's own sums (tests/test_torch_parallel*.py).
FSDP_LOSS_RTOL, FSDP_PARAM_RTOL = 1e-5, 1e-6


def _torchrun(nproc, *args):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={nproc}", *args]


def _run(name, cmd):
    """Run ``cmd`` from the checkout's root and print its "dist:" lines; fail
    with its output's tail unless it exits 0."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO_ROOT, capture_output=True, text=True,
                          timeout=DIST_TIMEOUT)
    if proc.returncode != 0:
        fail(f"{name}: exit {proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    for line in proc.stdout.splitlines():
        if line.startswith("dist:"):
            print(line, flush=True)
    print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)


def _summary(root):
    found = glob.glob(os.path.join(root, "**", "summary.json"), recursive=True)
    if len(found) != 1:
        fail(f"{root}: {len(found)} summary.json files, expected 1")
    with open(found[0]) as f:
        return json.load(f)


def _train_args(tmp, name, cfg_path, *flags):
    return ["--config-path", cfg_path, "--allow-bf16", "--epochs", "1", "--num-save-images", "0",
            "--exp-dir", os.path.join(tmp, f"dist_{name}"), *flags]


def _gen_args(tmp, name, ckpt, *flags):
    return ["--config-path", CONFIG, "--ckpt-path", ckpt, "--use-ema", "--use-ddim",
            "--allow-bf16", "--sample-timesteps", str(DIST_SAMPLE_STEPS), "--w-guide", "0",
            "--batch-size", "64", "--total-size", "128", "--seed", "0",
            "--save-dir", os.path.join(tmp, f"dist_gen_{name}"), *flags]


def _in_process(fn, args, tmp, name):
    """``fn(args)`` (a CLI's main); records the device memory this process
    held before it, which the run's peak then leaves out."""
    held = torch.cuda.memory_allocated()
    fn(args)
    with open(os.path.join(tmp, f"dist_{name}_held.json"), "w") as f:
        json.dump(held, f)


def _train_result(tmp, name):
    """A train run's summary (its peak less what its process held before)
    and its final params and EMA."""
    summary = _summary(os.path.join(tmp, f"dist_{name}"))
    with open(os.path.join(tmp, f"dist_{name}_held.json")) as f:
        summary["peak_bytes"] -= json.load(f)
    ckpt = torch.load(os.path.join(summary["ckpt_dir"], "ckpt_last.pt"), map_location="cpu",
                      weights_only=True)
    return summary, {"model": ckpt["model"], "ema": ckpt["ema"]["shadow"]}


def _max_rel(a, b):
    """The largest |a - b| over the state dicts, relative to the largest |b|."""
    err = max((a[k].float() - b[k].float()).abs().max().item() for k in b)
    return err / max(v.float().abs().max().item() for v in b.values())


def _png_hashes(root):
    import hashlib

    out = []
    for path in glob.glob(os.path.join(root, "**", "*.png"), recursive=True):
        with open(path, "rb") as f:
            out.append(hashlib.sha256(f.read()).hexdigest())
    return sorted(out)


def dist_clis_worker(tmp, cfg_path, ckpt):
    """The one torchrun rank of parts (a)-(c): the plain train CLI, train
    --distributed, train --fsdp, the plain generate CLI and generate --dp, one
    after another in this process (the distributed ones join the process
    group the first of them made)."""
    import gc

    from vdiff_tpu_torch import generate, train

    for name, flags in (("plain", ()), ("ddp", ("--distributed",)), ("fsdp", ("--fsdp",))):
        _in_process(train.main, _train_args(tmp, name, cfg_path, *flags), tmp, name)
        gc.collect()
    for name, flags in (("plain", ()), ("dp", ("--dp",))):
        generate.main(_gen_args(tmp, name, ckpt, *flags))


def phase_dist(tmp, ckpt, card):
    """The multi-GPU paths at world size 1 on NCCL, launched under torchrun:
    (a) train --distributed (DDP) and (b) train --fsdp against the plain
    train CLI (run first in the same process) from the same seed: DDP's losses, final
    params and EMA bit for bit, FSDP's within FSDP_LOSS_RTOL and
    FSDP_PARAM_RTOL, and TRAIN_STEP_LAUNCHES_BF16 a step; (c) generate --dp
    against the plain generate CLI: the same PNGs and 17 + 1 launches a
    forward; (d) two ranks on this one card over gloo with CUDA tensors: a
    DDP step against the one-rank step on the global batch. Returns each
    path's launches."""
    with open(TRAIN_CONFIG) as f:
        cfg = json.load(f)
    cfg["model"]["drop_rate"] = 0.0
    cfg["speedup"] = {"cudnn_benchmark": False}
    cfg_path = os.path.join(tmp, "flagship_nodrop.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    t0 = time.perf_counter()
    _run("dist: torchrun, one rank on NCCL (train plain, --distributed, --fsdp; generate plain, "
         "--dp)", _torchrun(1, os.path.abspath(__file__), "--dist-clis", tmp, cfg_path, ckpt))

    runs = {name: _train_result(tmp, name) for name in ("plain", "ddp", "fsdp")}
    want = {k: v * DIST_TRAIN_STEPS for k, v in TRAIN_STEP_LAUNCHES_BF16.items()}
    plain_summary, plain_ckpt = runs["plain"]
    launched = {}
    for name, (summary, ckpt_) in runs.items():
        same = (summary["losses"] == plain_summary["losses"]
                and all(torch.equal(ckpt_[part][k], plain_ckpt[part][k])
                        for part in ("model", "ema") for k in plain_ckpt[part]))
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(summary["losses"],
                                                           plain_summary["losses"]))
        param_err = max(_max_rel(ckpt_[part], plain_ckpt[part]) for part in ("model", "ema"))
        print(f"dist: train {name} world {summary.get('world_size')}: {summary['steps']} steps "
              f"of 128, losses {summary['losses']}, {summary['img_per_s']} img/s after the "
              f"first step, peak {summary['peak_bytes'] / 2**30:.3f} GiB, bit for bit with the "
              f"plain run: {same} (losses max rel err {loss_err}, params and EMA max rel err "
              f"{param_err}), launches {_nonzero(summary['launches'])} ({card})", flush=True)
        held = same if name != "fsdp" else (loss_err <= FSDP_LOSS_RTOL
                                            and param_err <= FSDP_PARAM_RTOL)
        if summary["steps"] != DIST_TRAIN_STEPS or not held:
            fail(f"dist: train {name} is not the plain run's")
        if {k: summary["launches"].get(k, 0) for k in KERNELS} != want:
            fail(f"dist: train {name} launched {summary['launches']}, expected {want}")
        if name != "plain":
            launched[f"{name}_train_cli"] = {k: summary["launches"].get(k, 0) for k in KERNELS}

    dp, plain_gen = (_summary(os.path.join(tmp, f"dist_gen_{name}")) for name in ("dp", "plain"))
    device = {k: dp["stats"]["launches"].get(k, 0) for k in KERNELS}
    counted = {k: device[k] + dp["stats"]["captured_launches"].get(k, 0)
               - dp["stats"]["replayed_launches"].get(k, 0) for k in KERNELS}
    launched["dp_generate"] = _device_launches("dist: generate --dp", counted,
                                               {**dp["stats"], "launches": device},
                                               SAMPLE_FWD_LAUNCHES_BF16, DIST_SAMPLE_STEPS * 2)
    same = (_png_hashes(os.path.join(tmp, "dist_gen_dp"))
            == _png_hashes(os.path.join(tmp, "dist_gen_plain")))
    print(f"dist: generate --dp world 1: {dp['images']} PNGs, the plain CLI's: {same}; "
          f"{dp['samples_per_s']} samples/s vs {plain_gen['samples_per_s']} plain, second batch "
          f"({card})", flush=True)
    if not same or dp["images"] != 128:
        fail("dist: generate --dp wrote other PNGs than the plain CLI")

    _run("dist: torchrun, two gloo ranks on one card (DDP step)",
         _torchrun(2, os.path.abspath(__file__), "--gloo-ddp"))
    print(f"dist: {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    return launched


def gloo_ddp_worker():
    """Part (d), one of two torchrun ranks on one card: the process group
    over gloo with CUDA tensors, the full-width f32 cifar10_cond UNet wrapped
    in DDP, this rank's half of a global batch of GLOO_B with the global
    draws; rank 0 then takes the one-rank step on the global batch from the
    same weights and holds the DDP step to it (loss, gradients, params)."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from vdiff_tpu_torch.factory import build_diffusion, load_experiment_config
    from vdiff_tpu_torch.train_lib import Optimizer, make_train_step

    dist.init_process_group("gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, _ = load_experiment_config(CONFIG)
    cond = cfg["conditional"]
    diffusion, timesteps = build_diffusion(cfg["diffusion"], w_guide=cond["w_guide"],
                                           p_uncond=cond["p_uncond"])
    model = _perturbed_unet(dict(cfg, model=dict(cfg["model"], drop_rate=0.0)))
    gen = torch.Generator().manual_seed(12)
    x = torch.rand(GLOO_B, 32, 32, 3, generator=gen) * 2 - 1
    y = torch.tensor([3, 7, 0, 5])
    draws = [{"t": torch.rand(GLOO_B, generator=gen),
              "noise": torch.randn(x.shape, generator=gen),
              "keep": torch.tensor([True, False, True, True])}]

    def step(m, xs, ys, r, w):
        m_cuda = copy.deepcopy(m).cuda()
        net = DistributedDataParallel(m_cuda, device_ids=[0]) if w > 1 else m_cuda
        opt = Optimizer(m_cuda.parameters(), lr=STEP_LR, weight_decay=1e-3, grad_norm=1e9)
        fn = make_train_step(net, diffusion, opt, timesteps, use_cfg=True, rank=r, world=w)
        before = _counts()
        loss = fn(xs.cuda(), ys.cuda(), 0, 0,
                  draws=[{k: v.cuda() for k, v in draws[0].items()}]).item()
        launched = {k: v - before[k] for k, v in _counts().items()}
        grads = torch.cat([p.grad.flatten().cpu() for p in m_cuda.parameters()])
        params = torch.cat([p.detach().flatten().cpu() for p in m_cuda.parameters()])
        return loss, grads, params, launched

    per = GLOO_B // world
    rows = slice(rank * per, (rank + 1) * per)
    loss, g, p, launched = step(model, x[rows], y[rows], rank, world)
    if launched != TRAIN_STEP_LAUNCHES:
        fail(f"gloo DDP rank {rank}: one step launched {launched}")
    if rank == 0:
        ref_loss, ref_g, ref_p, _ = step(model, x, y, 0, 1)
        loss_err = abs(loss - ref_loss) / abs(ref_loss)
        scale = ref_g.abs().max().item()
        grad_err = (g - ref_g).abs().max().item() / scale
        moved = (p - ref_p).abs() / STEP_LR
        signed = ref_g.abs() > STEP_GRAD_RTOL * scale
        param_err, near_zero_err = moved[signed].max().item(), moved.max().item()
        print(f"dist: gloo DDP, 2 ranks on one card, f32 B={GLOO_B}: loss {loss} vs the one-rank "
              f"step's {ref_loss} (rel {loss_err}), grads max err {grad_err} of the largest, "
              f"params {param_err} of lr ({near_zero_err} near zero), launches a rank "
              f"{_nonzero(launched)}", flush=True)
        if not (loss_err <= STEP_LOSS_RTOL and grad_err <= STEP_GRAD_RTOL
                and param_err <= STEP_PARAM_RTOL and near_zero_err <= STEP_SIGN_BOUND):
            fail("gloo DDP: the 2-rank step disagrees with the one-rank step")
    dist.barrier()
    dist.destroy_process_group()


# the mp phase (12c): the model-parallel serving modes on two ranks sharing
# the card over gloo with CUDA tensors (NCCL refuses two ranks on one GPU).
# (a) the full-width cifar10_cond f32 forward at B=2 under --tp, under
# --spatial-shard and under both, against the one-rank forward on the card
# within UNET_RTOL; (b) the generate CLI under --tp and under
# --spatial-shard on phase 4's checkpoint (bf16, MP_SAMPLE_STEPS DDIM steps at
# w=0, one batch of MP_SAMPLE_B), its eager loop on each rank; (c) the
# full-width celeba bf16 forward at B=2 under --tp against one rank within
# the bf16 UNet bound of tests/test_torch_unet.py, MP_BF16_RTOL of the output's
# scale, and the same weights in f32 within UNET_RTOL (a half-width bf16 conv
# or matmul may sum in another order and round an output the other way; in
# f32 the modes are exact or nearly). The kernels run per rank at whole-T
# shapes, as on one card.
MP_SAMPLE_B, MP_SAMPLE_STEPS = 16, 16
MP_BF16_RTOL = 4 * 2.0 ** -8
MP_MODES = {"tp": ("--tp",), "sp": ("--spatial-shard",), "tpsp": ("--tp", "--spatial-shard")}
# (d) generate --progressive under --tp and under --spatial-shard on phase 4's
# checkpoint at phase 4p's settings (PROGRESSIVE_STEPS DDIM steps at w=0.1, a
# snapshot every PROGRESSIVE_FREQ, B=MP_SAMPLE_B), in f32, against the plain
# CLI's f32 strips from the same seed: the f32 bound of (a), UNET_RTOL of
# max(1, max|ref|) (the strips are a v-model's clipped x̂_0, so no step divides
# by a small alpha), and the PNGs within one level of 255. In bf16 a
# half-width conv rounds other sums than the whole one, and 16 steps carry
# that past the bf16 forward bound, which the plain run itself keeps only
# against the same kernels; so these runs are f32.
MP_PROGRESSIVE_MODES = ("tp", "sp")


def _mp_gen_args(tmp, name, ckpt, *flags):
    return ["--config-path", CONFIG, "--ckpt-path", ckpt, "--use-ema", "--use-ddim",
            "--allow-bf16", "--sample-timesteps", str(MP_SAMPLE_STEPS), "--w-guide", "0",
            "--batch-size", str(MP_SAMPLE_B), "--total-size", str(MP_SAMPLE_B), "--seed", "0",
            "--save-dir", os.path.join(tmp, f"mp_gen_{name}"), *flags]


def _mp_progressive_args(tmp, name, ckpt, *flags):
    return ["--config-path", CONFIG, "--ckpt-path", ckpt, "--use-ema", "--use-ddim",
            "--sample-timesteps", str(PROGRESSIVE_STEPS), "--progressive", "--pred-freq",
            str(PROGRESSIVE_FREQ), "--w-guide", "0.1", "--batch-size", str(MP_SAMPLE_B),
            "--total-size", str(MP_SAMPLE_B), "--seed", "0",
            "--save-dir", os.path.join(tmp, f"mp_prog_{name}"), *flags]


def _captured_generate(args, out):
    """generate.main(args) with the float samples (strips) captured before the
    PNG writer quantises them, saved to ``out`` (np.save) by the process that
    writes the PNGs; returns the CLI's summary."""
    from vdiff_tpu_torch import generate

    captured, write = [], generate.write_pngs
    generate.write_pngs = lambda save_dir, x: (captured.append(np.array(x)), write(save_dir, x))
    try:
        summary = generate.main(args)
    finally:
        generate.write_pngs = write
    if captured:
        np.save(out, np.concatenate(captured))
    return summary


def phase_mp(tmp, ckpt, card):
    """The model-parallel serving modes (see MP_MODES' comment): the plain
    generate CLI at (b)'s settings in this process, then one torchrun launch
    of two gloo ranks on this card that runs (a)-(c) (mp_worker). Returns
    the launches of (b)'s two paths, summed over the ranks."""
    from vdiff_tpu_torch import generate

    t0 = time.perf_counter()
    plain = generate.main(_mp_gen_args(tmp, "plain", ckpt))
    plain_prog = _captured_generate(_mp_progressive_args(tmp, "plain", ckpt),
                                    os.path.join(tmp, "mp_prog_plain.npy"))
    _run("mp: torchrun, two gloo ranks on one card (TP, SP, TP+SP forwards; generate --tp, "
         "--spatial-shard, each also with --progressive; celeba TP forward)",
         _torchrun(2, os.path.abspath(__file__), "--mp", tmp, ckpt))
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"mp_rank{r}.json")) as f:
            ranks.append(json.load(f))
    for name in MP_MODES:
        fwd = [res["forward"][name] for res in ranks]
        print(f"mp: cifar10_cond f32 B=2 {' '.join(MP_MODES[name])}, 2 ranks: max_abs_err "
              f"{[f['err'] for f in fwd]} vs the one-rank forward (|ref|max {fwd[0]['scale']}), "
              f"parameter bytes a rank {[f['param_bytes'] for f in fwd]} of "
              f"{fwd[0]['param_bytes_total']}, peak allocated a rank "
              f"{[f['peak_bytes'] for f in fwd]} B (one rank: {ranks[0]['forward']['one_peak']} "
              f"B), launches a rank {_nonzero(fwd[0]['launches'])} ({card})", flush=True)
        for r, f in enumerate(fwd):
            if not f["finite"] or f["err"] > UNET_RTOL * f["scale"]:
                fail(f"mp: {name} forward on rank {r}: max err {f['err']} > {UNET_RTOL} * "
                     f"{f['scale']}")
            if f["launches"] != _launches(attn_fwd_online=ONLINE_PER_FWD,
                                          attn_fwd_qblk=QBLK_PER_FWD):
                fail(f"mp: {name} forward on rank {r} launched {f['launches']}")
    launched = {}
    for name in ("tp", "sp"):
        runs = [res["generate"][name] for res in ranks]
        want = {k: v * MP_SAMPLE_STEPS for k, v in SAMPLE_FWD_LAUNCHES_BF16.items()}
        per_rank = [{k: run["stats"]["launches"].get(k, 0) for k in KERNELS} for run in runs]
        pngs = len(glob.glob(os.path.join(tmp, f"mp_gen_{name}", "**", "*.png"), recursive=True))
        print(f"mp: generate {' '.join(MP_MODES[name])}, 2 ranks, bf16 B={MP_SAMPLE_B} "
              f"{MP_SAMPLE_STEPS} DDIM steps: {pngs} PNGs, finite "
              f"{[run['finite'] for run in runs]}, "
              f"{[run['images'] / run['seconds'] for run in runs]} samples/s a rank vs "
              f"{plain['images'] / plain['seconds']} plain (one batch, its warm-up included), "
              f"eager steps {[run['stats']['eager_steps'] for run in runs]}, graph "
              f"{[run['stats']['graph'] for run in runs]}, launches a rank "
              f"{[_nonzero(c) for c in per_rank]} ({card})", flush=True)
        if pngs != MP_SAMPLE_B or not all(run["finite"] for run in runs):
            fail(f"mp: generate {name}: {pngs} PNGs, finite {[run['finite'] for run in runs]}")
        for r, (run, counts) in enumerate(zip(runs, per_rank)):
            if (counts != want or run["stats"]["eager_steps"] != MP_SAMPLE_STEPS
                    or run["stats"]["graph"] or run["world_size"] != 2):
                fail(f"mp: generate {name} on rank {r}: launches {counts} (want {want}), "
                     f"stats {run['stats']}")
        launched[f"{name}_generate"] = {k: sum(c[k] for c in per_rank) for k in KERNELS}
    ref = np.load(os.path.join(tmp, "mp_prog_plain.npy"))
    quant = lambda a: np.clip(a * 127.5 + 127.5, 0, 255).astype(np.uint8).astype(int)  # noqa: E731
    bound = UNET_RTOL * max(1.0, float(np.abs(ref).max()))
    L = PROGRESSIVE_STEPS // PROGRESSIVE_FREQ
    want = {k: v * PROGRESSIVE_STEPS for k, v in NLL_FWD_LAUNCHES.items()}
    for name in MP_PROGRESSIVE_MODES:
        runs = [res["progressive"][name] for res in ranks]
        got = np.load(os.path.join(tmp, f"mp_prog_{name}.npy"))
        err = float(np.abs(got - ref).max()) if got.shape == ref.shape else math.inf
        levels = int(np.abs(quant(got) - quant(ref)).max()) if got.shape == ref.shape else 256
        pngs = glob.glob(os.path.join(tmp, f"mp_prog_{name}", "**", "*.png"), recursive=True)
        sizes = {_png_header(f)[:2] for f in pngs}
        per_rank = [{k: run["stats"]["launches"].get(k, 0) for k in KERNELS} for run in runs]
        print(f"mp: generate {' '.join(MP_MODES[name])} --progressive, 2 ranks, f32 "
              f"B={MP_SAMPLE_B} {PROGRESSIVE_STEPS} DDIM steps at w=0.1, a snapshot every "
              f"{PROGRESSIVE_FREQ}: {len(pngs)} strips of {sizes} (width, height), max_abs_err "
              f"{err} vs the plain CLI's f32 strips {got.shape} (bound UNET_RTOL x max(1, "
              f"|ref|max) = {bound}), PNGs "
              f"{levels} level(s) apart, finite {[run['finite'] for run in runs]}, "
              f"{[run['seconds'] for run in runs]} s of sampling a rank "
              f"({[run['images'] / run['seconds'] for run in runs]} samples/s) vs "
              f"{plain_prog['seconds']} s plain (one batch, its warm-up included), launches a "
              f"rank {[_nonzero(c) for c in per_rank]} ({card})", flush=True)
        if (got.shape != ref.shape or got.shape != (MP_SAMPLE_B, 32, 32 * L, 3)
                or not np.isfinite(got).all() or err > bound or levels > 1):
            fail(f"mp: generate {name} --progressive: strips {got.shape}, max err {err} "
                 f"(bound {bound}), {levels} levels")
        if len(pngs) != MP_SAMPLE_B or sizes != {(32 * L, 32)} or \
                not all(run["finite"] for run in runs):
            fail(f"mp: generate {name} --progressive: {len(pngs)} strips of {sizes}")
        for r, (run, counts) in enumerate(zip(runs, per_rank)):
            if (counts != want or run["stats"]["eager_steps"] != PROGRESSIVE_STEPS
                    or run["stats"]["graph"] or run["world_size"] != 2):
                fail(f"mp: generate {name} --progressive on rank {r}: launches {counts} (want "
                     f"{want}), stats {run['stats']}")
        launched[f"{name}_progressive"] = _f32_path(
            {k: sum(c[k] for c in per_rank) for k in KERNELS})
    for r, res in enumerate(ranks):
        c = res["celeba"]
        print(f"mp: celeba bf16 B=2 --tp rank {r}: max_abs_err {c['err']} vs the one-rank forward "
              f"(|ref|max {c['scale']}; {c['err'] / (MP_BF16_RTOL * c['scale'])} of the bound), "
              f"the same weights in f32 {c['f32_err']} (|ref|max {c['f32_scale']}), parameter "
              f"bytes {c['param_bytes']} of {c['param_bytes_total']}, launches "
              f"{_nonzero(c['launches'])} (f32 {_nonzero(c['f32_launches'])}) ({card})", flush=True)
        if not c["finite"] or c["err"] > MP_BF16_RTOL * c["scale"]:
            fail(f"mp: celeba TP forward on rank {r}: max err {c['err']} > {MP_BF16_RTOL} * "
                 f"{c['scale']}")
        if c["f32_err"] > UNET_RTOL * c["f32_scale"]:
            fail(f"mp: celeba f32 TP forward on rank {r}: max err {c['f32_err']} > {UNET_RTOL} * "
                 f"{c['f32_scale']}")
        if c["launches"] != CELEBA_FWD_LAUNCHES_BF16 or c["f32_launches"] != CELEBA_FWD_LAUNCHES:
            fail(f"mp: celeba TP forward on rank {r} launched {c['launches']} (f32 "
                 f"{c['f32_launches']})")
    print(f"mp: {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    return launched


def _mp_forwards(model, x, t, y):
    """The one-rank forward of ``model`` (on the CPU, whole) on the card,
    then the same under each mode; each mode's error, parameter bytes, peak
    memory and launches on this rank."""
    from vdiff_tpu_torch.parallel import (SpatialShardedUNet, state_bytes_per_device,
                                          tp_shard_model_)

    x, t, y = x.cuda(), t.cuda(), y.cuda()
    out = {}
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        plain = copy.deepcopy(model).cuda()
        ref = plain(x, t, y).float()
        out["one_peak"] = torch.cuda.max_memory_allocated()
        total = state_bytes_per_device(plain)
        del plain
        for name, flags in MP_MODES.items():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            m = copy.deepcopy(model)
            if "--tp" in flags:  # on the host, as the generate CLI shards
                tp_shard_model_(m)
            m = m.cuda()
            net = SpatialShardedUNet(m) if "--spatial-shard" in flags else m
            _reset_counts()
            got = net(x, t, y).float()
            out[name] = {"err": (got - ref).abs().max().item(),
                         "scale": max(1.0, ref.abs().max().item()),
                         "finite": bool(torch.isfinite(got).all()), "launches": _counts(),
                         "param_bytes": state_bytes_per_device(m), "param_bytes_total": total,
                         "peak_bytes": torch.cuda.max_memory_allocated()}
            del m, net
    return out


def _compute_dtype(model, dtype):
    """Set the compute dtype of ``model`` and of every block that casts to
    its own (the UNet casts its f32 weights at use, so this is the model
    built with ``dtype``)."""
    for m in model.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = dtype


def mp_worker(tmp, ckpt):
    """One of the mp phase's two torchrun ranks on one card: the gloo group
    with CUDA tensors, then (a) the cifar10_cond forwards, (b) the generate
    CLI under --tp and --spatial-shard (in this process; it keeps the group)
    and (c) the celeba TP forward; writes this rank's results to
    ``tmp/mp_rank<r>.json``."""
    import torch.distributed as dist

    from vdiff_tpu_torch import generate
    from vdiff_tpu_torch.factory import load_experiment_config

    dist.init_process_group("gloo")
    rank = dist.get_rank()
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    cfg, _ = load_experiment_config(CONFIG)
    gen = torch.Generator().manual_seed(7)  # phase 3's inputs
    x, t = torch.randn(2, 32, 32, 3, generator=gen), torch.rand(2, generator=gen)
    res["forward"] = _mp_forwards(_perturbed_unet(cfg), x, t, torch.tensor([3.0, 0.0]))
    res["generate"] = {}
    for name in ("tp", "sp"):
        _reset_counts()
        summary = generate.main(_mp_gen_args(tmp, name, ckpt, *MP_MODES[name]))
        res["generate"][name] = {k: summary[k] for k in ("images", "finite", "seconds", "stats",
                                                         "world_size")}
    res["progressive"] = {}
    for name in MP_PROGRESSIVE_MODES:
        _reset_counts()
        summary = _captured_generate(_mp_progressive_args(tmp, name, ckpt, *MP_MODES[name]),
                                     os.path.join(tmp, f"mp_prog_{name}.npy"))
        res["progressive"][name] = {k: summary[k] for k in ("images", "finite", "seconds", "stats",
                                                            "world_size")}
    celeba_cfg, _ = load_experiment_config(CELEBA_CONFIG)
    celeba = _perturbed_unet(dict(celeba_cfg, model=dict(celeba_cfg["model"], drop_rate=0.0)),
                             num_classes=40, multitags=True, dtype=torch.bfloat16)
    x, y = _celeba_inputs(2, torch.Generator().manual_seed(8))
    t = torch.rand(2, generator=torch.Generator().manual_seed(9))
    from vdiff_tpu_torch.parallel import state_bytes_per_device, tp_shard_model_

    x, t, y = x.cuda(), t.cuda(), y.cuda()
    with torch.inference_mode():
        celeba_cuda = celeba.cuda()
        ref = celeba_cuda(x, t, y).float()
        _compute_dtype(celeba_cuda, torch.float32)  # the same weights in f32
        ref32 = celeba_cuda(x, t, y)
        total = state_bytes_per_device(celeba_cuda)
        tp_shard_model_(celeba_cuda)
        _reset_counts()
        got32 = celeba_cuda(x, t, y)
        launches32 = _counts()
        _compute_dtype(celeba_cuda, torch.bfloat16)
        _reset_counts()
        got = celeba_cuda(x, t, y).float()
    res["celeba"] = {"err": (got - ref).abs().max().item(), "scale": ref.abs().max().item(),
                     "finite": bool(torch.isfinite(got).all()), "launches": _counts(),
                     "f32_err": (got32 - ref32).abs().max().item(),
                     "f32_scale": max(1.0, ref32.abs().max().item()), "f32_launches": launches32,
                     "param_bytes": state_bytes_per_device(celeba_cuda),
                     "param_bytes_total": total}
    with open(os.path.join(tmp, f"mp_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the eval path: nll, the metric nets, the dress rehearsal, the Evaluator
# ---------------------------------------------------------------------------

# the nll phase: the eval CLI over synthetic's test images in f32, so every
# forward runs B1's and B2's f32 calls (attn_fwd_online ×17 and attn_fwd_qblk
# ×1, both attn_fwd_tf32.cu); and calc_all_bpd on CUDA against the CPU
NLL_B, NLL_TOTAL = 64, 128
NLL_FWD_LAUNCHES = _launches(attn_fwd_online=ONLINE_PER_FWD, attn_fwd_qblk=QBLK_PER_FWD)
BPD_B, BPD_T = 2, 8
# total bits/dim on CUDA vs the CPU, relative: the terms move with the UNet's
# output (UNET_RTOL). The decoder's NLL (step 0) takes -log of bin masses that
# f32 resolves only to ~2^-24 near a CDF of 0 or 1, so a tail bin whose mass
# rounds the other way moves the total by ~1e-4 of itself: the bound holds ~10
BPD_RTOL = 1e-3
# the metric nets, f32 on the card (TF32 off) vs the CPU, same 8 images:
# 1e-3 of max|ref| (cuDNN's and the CPU's conv sums in other orders over
# ~95 convs)
METRIC_NET_RTOL, METRIC_NET_IMAGES = 1e-3, 8
# the dress rehearsal: two folders of the full-width model's samples (16
# DDIM steps, bf16), one of uniform noise
REHEARSAL_N, REHEARSAL_NOISE_N, REHEARSAL_STEPS = 1024, 1024, 16
FID_SELF_BOUND = 1e-2


def phase_nll(cfg, model, ckpt):
    """The eval CLI's nll on the full-width cifar10_cond checkpoint (f32, the
    config's 256 steps, 2 batches of 64 synthetic test images): finite bits/dim
    and, per forward, B1 ×17 and B2 ×1 on attn_fwd_tf32.cu; then calc_all_bpd
    at B=2, T=8 on CUDA against the CPU, same weights and noise. Returns the
    run's launches under the f32 kernels' names."""
    from vdiff_tpu_torch import eval as eval_cli

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eval_cli.main(["--dataset", "synthetic", "--metrics", "nll", "--config-path", CONFIG,
                         "--ckpt-path", ckpt, "--use-ema", "--eval-batch-size", str(NLL_B),
                         "--eval-total-size", str(NLL_TOTAL)])
    seconds = time.perf_counter() - t0
    launched = _counts()
    forwards = STEPS * (NLL_TOTAL // NLL_B)
    print(f"nll: cifar10_cond f32, {NLL_TOTAL} synthetic test images in batches of {NLL_B}, "
          f"{STEPS} steps: {out.get('nll')} bits/dim in {seconds:.1f} s, "
          f"{forwards / seconds:.2f} forwards/s ({forwards * NLL_B / seconds:.1f} images·steps/s, "
          f"the first batch's warm-up included), launches {_nonzero(launched)}", flush=True)
    if not isinstance(out.get("nll"), float) or not math.isfinite(out["nll"]):
        fail(f"nll: {out}")
    want = {k: v * forwards for k, v in NLL_FWD_LAUNCHES.items()}
    if launched != want:
        fail(f"nll: launches {launched}, expected {want}")

    _bpd_parity("nll", cfg, model)
    return _f32_path(launched)


def _bpd_parity(phase, cfg, model, B=BPD_B, T=BPD_T, res=32, y=None, per_fwd=NLL_FWD_LAUNCHES):
    """calc_all_bpd at B, T on the f32 ``model`` on CUDA against the CPU, same
    weights, labels (``y``; classes 3 and 7 for a class-conditional model
    without it) and noise, on B seeded images of res x res on the 8-bit grid:
    the total bits/dim within BPD_RTOL relative, ``per_fwd`` launches a
    forward. Returns the CUDA run's launches under the f32 kernels' names."""
    from vdiff_tpu_torch.factory import build_diffusion

    diffusion, _ = build_diffusion(cfg["diffusion"], w_guide=0.0, sample_timesteps=T,
                                   continuous_gate=False)
    gen = torch.Generator().manual_seed(30)
    x_0 = torch.randint(0, 256, (B, res, res, 3), generator=gen).float() / 127.5 - 1.0
    if y is None and model.num_classes:
        y = torch.tensor([3.0, 7.0])
    noise = torch.randn((T,) + tuple(x_0.shape), generator=gen)
    model_gpu = copy.deepcopy(model).cuda()
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = diffusion.calc_all_bpd(model_gpu, x_0.cuda(), None if y is None else y.cuda(),
                                 noise=noise.cuda())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = _counts()
    del model_gpu
    ref = diffusion.calc_all_bpd(model, x_0, y, noise=noise)
    total, ref_total = got[0].cpu().numpy(), ref[0].numpy()
    err = abs(total - ref_total)
    bound = BPD_RTOL * abs(ref_total)
    kl_err = (got[1][:, 1:].cpu() - ref[1][:, 1:]).abs().max().item()
    print(f"{phase}: calc_all_bpd B={B} T={T} f32 cuda vs cpu: total {total} vs "
          f"{ref_total}, err {err} ({(err / abs(ref_total)).tolist()} relative, bound {BPD_RTOL}), "
          f"KL terms max err {kl_err} of {ref[1][:, 1:].abs().max().item()}, decoder terms "
          f"{got[1][:, 0].tolist()} vs {ref[1][:, 0].tolist()}, launches {_nonzero(launched)}, "
          f"{T / seconds:.2f} forwards/s at B={B} on the card (the first call's warm-up "
          f"included)", flush=True)
    if not (bool((err <= bound).all()) and math.isfinite(float(total.sum()))):
        fail(f"{phase}: calc_all_bpd cuda {total} vs cpu {ref_total}, bound {bound}")
    want = {k: v * T for k, v in per_fwd.items()}
    if launched != want:
        fail(f"{phase}: calc_all_bpd launched {launched}, expected {want}")
    return _f32_path(launched)


# celeba's nll at full width: calc_all_bpd at B=1, T=4 in f32 (the eval CLI's
# type), B6's f32 calls on attn_fwd_tf32.cu under attn_fwd_pack1's count;
# B6 alone at the shapes a forward gives it at B=1 (N, T): up_1_us's T=4096,
# down_1_*/up_1_* at T=1024, down_1_ds at T=256 and up_3_us's T=256 at N=12
CELEBA_NLL_B, CELEBA_NLL_T = 1, 4
CELEBA_NLL_SHAPES = ((4096, 6), (1024, 6), (256, 6), (256, 12))


def phase_celeba_nll(cfg, model):
    """celeba's nll at full width in f32 with TF32 off, as the eval CLI runs
    it: (a) attn_fwd_pack1 (B6) in f32, attn_fwd_tf32.cu, at B=1 and each of
    CELEBA_NLL_SHAPES against its twins (_check_f32_fwd), timed beside the
    f32-FMA kernel it replaced (attn_fwd_online.cu), the twin, SDPA in f32
    and the card's f32 bound; (b) calc_all_bpd at B=1, T=4 on
    the f32 celeba UNet on CUDA against the CPU, seeded images and multi-hot
    tags, same weights and noise: the total within BPD_RTOL relative,
    CELEBA_FWD_LAUNCHES a forward. Returns (a)'s record (the first shape's,
    every shape's under "shapes") and (b)'s launches."""
    from vdiff_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(26)
    record, B, C = {}, CELEBA_NLL_B, 64
    for T, N in CELEBA_NLL_SHAPES:
        qkv = torch.randn(B, T, 3 * N * C, device="cuda", generator=gen)
        tag = f"attn_fwd_pack1 B={B} T={T} N={N} C={C} float32"
        errs = _check_f32_fwd(tag, A.attn_fwd_pack1(qkv, N), qkv, N, fma_fwd_online(qkv, N),
                              A.attention_qkv_lse_reference(qkv, N)[0])
        rec = {**errs, "ms": cuda_ms(lambda: A.attn_fwd_pack1(qkv, N), iters=5),
               "before_ms": cuda_ms(lambda: fma_fwd_online(qkv, N), iters=5),
               "plain_ms": cuda_ms(lambda: A.attention_qkv_lse_reference(qkv, N), iters=5),
               "library_ms": cuda_ms(_sdpa(qkv, N), iters=5),
               **_bound("fwd", B, T, N, C, torch.float32)}
        print(f"celeba-nll: {tag}: {_fmt(rec)} (library: SDPA in f32)", flush=True)
        _keep_shape(record, "attn_fwd_pack1_f32", (B, T, N, C), rec)
        del qkv
    torch.cuda.empty_cache()
    _, y = _celeba_inputs(CELEBA_NLL_B, torch.Generator().manual_seed(27))
    launched = _bpd_parity("celeba-nll", cfg, model, B=CELEBA_NLL_B, T=CELEBA_NLL_T, res=64, y=y,
                           per_fwd=CELEBA_FWD_LAUNCHES)
    torch.cuda.empty_cache()
    return record, launched


def _write_metric_weights(pre):
    """Release-format synthetic weights in ``pre``: the FID Inception (with
    its IS head) and VGG16, both through manifests.he_rescaled, so their
    features depend on the images (and VGG's fc7 stays within float16's
    range, where P&R keeps its features)."""
    from vdiff_tpu_torch.metrics import inception, vgg
    from vdiff_tpu_torch.metrics.manifests import (fid_inception_manifest, he_rescaled,
                                                   synth_state_dict, vgg16_manifest)

    os.makedirs(pre, exist_ok=True)
    inc = he_rescaled(synth_state_dict(fid_inception_manifest(), seed=0))
    vgg_sd = he_rescaled(synth_state_dict(vgg16_manifest(), seed=1))
    for sd, name in ((inc, inception.FID_WEIGHTS_FILENAME), (vgg_sd, vgg.VGG_FILENAMES[1])):
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                   os.path.join(pre, name))


def phase_metric_nets(pre):
    """The Inception's 2048-d features and IS probabilities and VGG16's fc7
    from the written weights, f32 on the card vs the CPU on the same 8
    images; then each net's images/s on the card at the eval CLI's batch."""
    from vdiff_tpu_torch.metrics import inception, vgg

    imgs = np.random.RandomState(31).randint(0, 256, (METRIC_NET_IMAGES, 32, 32, 3)).astype(np.uint8)
    nets = {
        "inception": inception._load_inception(
            os.path.join(pre, inception.FID_WEIGHTS_FILENAME), True, "cpu"),
        "vgg16": vgg.VGG16Features(),
    }
    vgg.load_vgg_state_dict(nets["vgg16"], torch.load(os.path.join(pre, vgg.VGG_FILENAMES[1]),
                                                      weights_only=True))
    inputs = {"inception": torch.from_numpy(imgs.astype(np.float32) / 127.5 - 1.0),
              "vgg16": torch.from_numpy(imgs.astype(np.float32))}

    def outputs(name, net, x):
        with torch.inference_mode():
            out = net(x)
        if name == "inception":
            return {"features": out[0][:, 0, 0, :], "is_probs": torch.softmax(out[1], -1)}
        return {"fc7": out}

    for name, net in nets.items():
        ref = outputs(name, net, inputs[name])
        net.cuda()
        got = outputs(name, net, inputs[name].cuda())
        for key, r in ref.items():
            scale = r.abs().max().item()
            err = (got[key].cpu() - r).abs().max().item()
            print(f"metric-nets: {name} {key} f32 cuda vs cpu, {METRIC_NET_IMAGES} images: max_abs_err "
                  f"{err} (bound {METRIC_NET_RTOL} x max|ref| {scale})", flush=True)
            if not (scale > 0 and err <= METRIC_NET_RTOL * scale):
                fail(f"metric-nets: {name} {key} err {err} > {METRIC_NET_RTOL} * {scale}")
        B = 256
        x = inputs[name][:1].cuda().expand(B, -1, -1, -1).contiguous()
        with torch.inference_mode():
            ms = cuda_ms(lambda: net(x), iters=5, warmup=2)
        print(f"metric-nets: {name} f32 B={B} (32x32 in, {299 if name == 'inception' else 224}"
              f" after the resize): {ms:.2f} ms a batch, {B / ms * 1e3:.1f} images/s", flush=True)
        net.cpu()
    torch.cuda.empty_cache()


def phase_rehearsal(ckpt, tmp, pre):
    """generate → fid --save-stats → eval: two folders A and B of the
    full-width model's samples (bf16, REHEARSAL_STEPS DDIM steps, w=0, other
    seeds) and one of uniform noise; A's statistics written by the fid CLI,
    A's P&R manifold cache written beside them; then the eval CLI's fid, is
    and pr on A, with cwd at ``tmp`` so the search directories find the
    weights. FID(A, A's stats) < 1e-2, FID(A, B) finite and below FID(A,
    noise), P&R (1, 1), IS finite and ≥ 1."""
    from vdiff_tpu_torch import eval as eval_cli
    from vdiff_tpu_torch import generate
    from vdiff_tpu_torch.data import ImageFolder
    from vdiff_tpu_torch.metrics import fid
    from vdiff_tpu_torch.metrics.precision_recall import ManifoldBuilder

    t0 = time.perf_counter()
    folders = {}
    for name, seed in (("A", "1"), ("B", "2")):
        summary = generate.main([
            "--config-path", CONFIG, "--ckpt-path", ckpt, "--save-dir", os.path.join(tmp, name),
            "--use-ema", "--use-ddim", "--allow-bf16", "--sample-timesteps", str(REHEARSAL_STEPS),
            "--w-guide", "0", "--batch-size", "256", "--total-size", str(REHEARSAL_N),
            "--seed", seed])
        if summary["images"] != REHEARSAL_N or not summary["finite"]:
            fail(f"rehearsal: generate {name} gave {summary}")
        folders[name] = summary["save_dir"]
    folders["noise"] = os.path.join(tmp, "noise")
    os.makedirs(folders["noise"])
    generate.write_pngs(folders["noise"], np.random.RandomState(32).uniform(
        -1, 1, (REHEARSAL_NOISE_N, 32, 32, 3)).astype(np.float32))
    t_gen = time.perf_counter() - t0

    stats = os.path.join(pre, "fid_stats_synthetic.npz")
    cwd = os.getcwd()
    os.chdir(tmp)  # the loaders' search directories are relative: ./precomputed
    try:
        marks = [time.perf_counter()]
        fid.main([folders["A"], stats, "--save-stats"])
        ManifoldBuilder(data=ImageFolder(folders["A"]), extr_batch_size=256).save(
            os.path.join(pre, "pr_manifold_synthetic_train.npz"))
        marks.append(time.perf_counter())
        out = eval_cli.main(["--dataset", "synthetic", "--metrics", "fid", "is", "pr",
                             "--eval-dir", folders["A"], "--eval-batch-size", "256",
                             "--eval-total-size", str(REHEARSAL_N)])
        marks.append(time.perf_counter())
        fid_ab = fid.main([stats, folders["B"]])
        marks.append(time.perf_counter())
        fid_noise = fid.main([stats, folders["noise"]])
        marks.append(time.perf_counter())
        t_metrics = marks[-1] - marks[0]
        split = ", ".join(f"{name} {b - a:.1f} s" for name, a, b in zip(
            ("stats and manifold", "eval fid/is/pr", "fid A-B", "fid A-noise"), marks, marks[1:]))
    finally:
        os.chdir(cwd)
    is_mean, is_std = (float(v) for v in str(out.get("is", "nan +/- nan")).split(" +/- "))
    pr = tuple(float(v) for v in str(out.get("pr", "nan/nan")).split("/"))
    print(f"rehearsal: {2 * REHEARSAL_N} samples (A, B) + {REHEARSAL_NOISE_N} noise PNGs in "
          f"{t_gen:.1f} s; metrics in {t_metrics:.1f} s ({split}): FID(A, stats of A) {out.get('fid')}, "
          f"FID(A, B) {fid_ab}, FID(A, noise) {fid_noise}, P&R {pr}, IS {is_mean} +/- {is_std} "
          "(synthetic Inception/VGG weights, random UNet)", flush=True)
    if not (isinstance(out.get("fid"), float) and abs(out["fid"]) < FID_SELF_BOUND):
        fail(f"rehearsal: FID(A, stats of A) {out.get('fid')}")
    if not (math.isfinite(fid_ab) and fid_ab < fid_noise):
        fail(f"rehearsal: FID(A, B) {fid_ab}, FID(A, noise) {fid_noise}")
    if pr != (1.0, 1.0):
        fail(f"rehearsal: P&R of A against its own manifold {pr}")
    if not (math.isfinite(is_mean) and is_mean >= 1.0 and math.isfinite(is_std)):
        fail(f"rehearsal: IS {out.get('is')}")
    return stats


def phase_evaluator(cfg, model, tmp, pre):
    """train_lib.Evaluator with the Trainer's eval sampler (graph-replayed
    DDIM, REHEARSAL_STEPS steps, w=0, conditional labels) on the full-width
    bf16 model: max_eval_count 256 at batch 128 (3 batches) against A's
    statistics; the FID must be finite."""
    from vdiff_tpu_torch.factory import build_diffusion, build_unet
    from vdiff_tpu_torch.train_lib import Evaluator, Trainer

    with torch.device("meta"):
        bf16 = build_unet(cfg["model"], in_channels=3, model_out_type=cfg["diffusion"]["model_out_type"],
                          num_classes=10, multitags=False, dtype=torch.bfloat16)
    bf16.load_state_dict({k: v.cuda() for k, v in model.state_dict().items()}, assign=True)
    diffusion, timesteps = build_diffusion(cfg["diffusion"], w_guide=0.0,
                                           sample_timesteps=REHEARSAL_STEPS, continuous_gate=False)
    trainer = Trainer(bf16.eval(), diffusion, timesteps, epochs=1, trainloader=None, use_cfg=True,
                      shape=(32, 32, 3), device="cuda")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        evaluator = Evaluator("synthetic", diffusion=diffusion, eval_batch_size=128,
                              max_eval_count=256, precomputed_dir=pre, device="cuda")
        t0 = time.perf_counter()
        out = evaluator.eval(trainer.eval_sampler(0, use_ddim=True))
        seconds = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    s = trainer.sampler_stats
    print(f"evaluator: FID {out.get('fid')} of {evaluator.istats.count} samples against A's "
          f"statistics in {seconds:.1f} s ({s['eager_steps']} eager steps, {s['captures']} "
          f"captures, {s['replays']} replays)", flush=True)
    if not (isinstance(out.get("fid"), float) and math.isfinite(out["fid"])) or \
            s["captures"] != 3 or s["replays"] != 3 * (REHEARSAL_STEPS - 1):
        fail(f"evaluator: {out}, sampler stats {s}")
    del trainer, bf16
    torch.cuda.empty_cache()

# the quality gate (phase 4i): python -m vdiff_tpu_torch.quality_gate at the
# cifar10_cond widths (synthetic_flagship.json) in f32, as the JAX gate runs
# them (it passes no --allow-bf16), from <tmp>, where 4f's synthetic metric
# weights and 4g's FID statistics and P&R manifold lie in ./precomputed: the
# train stage takes GATE_TRAIN_STEPS steps of 128 on the 512 synthetic images
# and draws the epoch-end grid (the config's 16 images, STEPS DDIM steps);
# generate writes GATE_IMAGES PNGs in batches of 128 at GATE_SAMPLE_STEPS steps;
# eval runs fid, is, pr on GATE_EVAL images and nll on as many test images in
# one batch, STEPS steps. Every stage is a process of its own; the kernels
# built in this one load from vdiff_tpu_torch/_build.
GATE_IMAGES, GATE_SAMPLE_STEPS, GATE_EVAL, GATE_TRAIN_STEPS = 256, 16, 64, 4
GATE_ARGS = ["--config", "vdiff_tpu_torch/configs/synthetic_flagship.json", "--dataset",
             "synthetic", "--epochs", "1", "--batch-size", "128", "--total-size", str(GATE_IMAGES),
             "--sample-timesteps", str(GATE_SAMPLE_STEPS), "--eval-total-size", str(GATE_EVAL),
             "--eval-batch-size", str(GATE_EVAL), "--metrics", "fid", "is", "pr", "nll"]
GATE_TIMEOUT = 600


def _finite(text, sep):
    """Whether every number in ``text`` (a metric the eval CLI prints as
    "a +/- b" or "a/b", or a float) is finite."""
    try:
        return all(math.isfinite(float(v)) for v in str(text).split(sep))
    except ValueError:
        return False


def phase_gate(tmp, pre, card):
    """The quality gate at full width (GATE_ARGS) in a subprocess whose
    working directory holds ``pre`` as ./precomputed: exit 0, the JSON last
    line, GATE_IMAGES finite PNGs, and fid, is, pr and nll all computed and
    finite by the eval stage (a metric skipped for want of weights fails
    here). Each stage's launches are read from its own summary (train's and
    generate's summary.json, eval's eval_summary.json): TRAIN_STEP_LAUNCHES
    a step and the grid's NLL_FWD_LAUNCHES a forward, 17 + 1 a forward for
    generate and eval's nll, all on the f32 kernels. Returns the three
    stages' launches (paths gate_train, gate_generate, gate_eval) and the
    train stage's img/s after its first step: the train CLI as it runs by
    default, in f32, on synthetic_flagship.json at B=128."""
    work = os.path.join(tmp, "gate")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO_ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "vdiff_tpu_torch.quality_gate", *GATE_ARGS,
                           "--work-dir", work, "--precomputed-dir", pre],
                          cwd=tmp, env=env, capture_output=True, text=True, timeout=GATE_TIMEOUT)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"gate: exit {proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    for line in lines:
        if line.startswith(("===", "---", "checkpoint:", "FID", "IS", "PR", "NLL", "1/1 epochs",
                            "batch ", "nll ")):
            print(f"gate: {line}", flush=True)
    last = json.loads(lines[-1])
    images = last["images"]
    gen = _summary(images)
    with open(os.path.join(images, "eval_summary.json")) as f:
        ev = json.load(f)
    train = _summary(os.path.join(work, "exps"))
    results = ev["results"]
    pngs = len(glob.glob(os.path.join(images, "*.png")))
    print(f"gate: quality_gate {last['quality_gate']} in {seconds:.1f} s (three processes; "
          f"{card}): train {train['steps']} steps, loss {train['loss']}, {train['img_per_s']} "
          f"img/s after the first step; generate {gen['images']} images, finite={gen['finite']}, "
          f"{gen.get('samples_per_s')} samples/s after the first batch; eval in "
          f"{ev['seconds']:.1f} s: {results}", flush=True)
    if last["quality_gate"] != "ok" or pngs != GATE_IMAGES or gen["images"] != GATE_IMAGES or \
            not gen["finite"]:
        fail(f"gate: {last}, {pngs} PNGs, generate summary {gen}")
    if not (isinstance(results.get("fid"), float) and math.isfinite(results["fid"])
            and _finite(results.get("is"), " +/- ") and _finite(results.get("pr"), "/")
            and isinstance(results.get("nll"), float) and math.isfinite(results["nll"])):
        fail(f"gate: eval results {results}: every metric must be computed and finite")
    if train["steps"] != GATE_TRAIN_STEPS or not math.isfinite(train["loss"]):
        fail(f"gate: train {train['steps']} steps, loss {train['loss']}")

    # train: the steps, then the grid's graph-replayed sampler (its captures
    # launched nothing, its replays uncounted)
    sampler = train["sampler"]
    train_dev = {k: train["launches"].get(k, 0) - sampler["captured_launches"].get(k, 0)
                 + sampler["replayed_launches"].get(k, 0) for k in KERNELS}
    want = {k: v * GATE_TRAIN_STEPS + NLL_FWD_LAUNCHES[k] * STEPS
            for k, v in TRAIN_STEP_LAUNCHES.items()}
    if train_dev != want:
        fail(f"gate: train launched {train_dev}, expected {want}")
    device = {k: gen["stats"]["launches"].get(k, 0) for k in KERNELS}
    counted = {k: device[k] + gen["stats"]["captured_launches"].get(k, 0)
               - gen["stats"]["replayed_launches"].get(k, 0) for k in KERNELS}
    gen_dev = _device_launches("gate: generate", counted, {**gen["stats"], "launches": device},
                               NLL_FWD_LAUNCHES, GATE_SAMPLE_STEPS * GATE_IMAGES // 128)
    ev_dev = {k: ev["launches"].get(k, 0) for k in KERNELS}
    if ev_dev != {k: v * STEPS for k, v in NLL_FWD_LAUNCHES.items()}:
        fail(f"gate: eval launched {ev_dev}, expected {NLL_FWD_LAUNCHES} x {STEPS}")
    nll_s = ev["metric_seconds"]["nll"]
    print(f"gate: f32 launches: train {_nonzero(train_dev)}, generate {_nonzero(gen_dev)}, eval "
          f"{_nonzero(ev_dev)}; eval's nll {STEPS} forwards at B={GATE_EVAL} in {nll_s:.2f} s, "
          f"{STEPS / nll_s:.2f} forwards/s (model load and warm-up included)", flush=True)
    return ({"gate_train": _f32_path(train_dev), "gate_generate": _f32_path(gen_dev),
             "gate_eval": _f32_path(ev_dev)}, train["img_per_s"])


def _timed(name, phase, *args):
    """``phase(*args)``, then a line with its seconds on the host clock."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"{name}: the phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs an NVIDIA GPU")
    from vdiff_tpu_torch.factory import load_experiment_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = phase_card()
    record = phase_kernels()
    cfg, _ = load_experiment_config(CONFIG)
    model = phase_unet(cfg)
    phase_graph(cfg)
    by_path = {}  # each main path's device launches, read just after its run
    with tempfile.TemporaryDirectory() as tmp:
        by_path["cifar_sample"], ckpt, default_rate = phase_sample(model, tmp)
        by_path["cifar_ancestral"] = _timed("ancestral", phase_ancestral_sample, ckpt, tmp)
        # the eval path: nll in f32 (the eval path's launches), then the
        # metric nets, the dress rehearsal and the Evaluator
        by_path["eval_nll"] = phase_nll(cfg, model, ckpt)
        pre = os.path.join(tmp, "precomputed")
        _write_metric_weights(pre)
        phase_metric_nets(pre)
        phase_rehearsal(ckpt, tmp, pre)
        phase_evaluator(cfg, model, tmp, pre)
        gate_paths, gate_img_per_s = _timed("gate", phase_gate, tmp, pre, card)
        by_path.update(gate_paths)
        del model
        phase_progressive(ckpt, tmp)
        record.update(phase_fused_kernels())
        phase_fused_unet(cfg)
        by_path.update(phase_fused_sample(ckpt, tmp, default_rate))
        for name, r in phase_train_kernels().items():  # the sampling shape's record stays
            record.setdefault(name, r)
        phase_train_unet(cfg)
        by_path["cifar_train_cli"] = phase_train_cli(tmp)
        by_path["cifar_train_cli_remat"] = phase_train_cli_remat(tmp)
        # the train CLI turns cuDNN's autotuner on (defaults.json); the later
        # phases run as the generate CLI and the profile scripts do, without it
        torch.backends.cudnn.benchmark = False
        # the configurations besides cifar10_cond and celeba
        mnist_paths, mnist_shapes = _timed("mnist", phase_mnist, tmp)
        by_path.update(mnist_paths)
        for name, shapes in mnist_shapes.items():
            record[name]["shapes"] = shapes
        by_path.update(_timed("uncond", phase_uncond))
        by_path.update(_timed("learned", phase_learned, cfg))

        record.update(phase_celeba_kernels())
        celeba_cfg, _ = load_experiment_config(CELEBA_CONFIG)
        model = phase_celeba_unet(celeba_cfg)
        phase_celeba_train_unet(celeba_cfg, model)
        nll_record, by_path["celeba_nll"] = _timed("celeba-nll", phase_celeba_nll, celeba_cfg,
                                                   model)
        record.update(nll_record)
        bf16 = _celeba_bf16(celeba_cfg, model)
        conv_shapes = _timed("celeba-fused", phase_celeba_fused, bf16)
        record["fused_gn_silu_conv3x3"].setdefault("shapes", []).extend(conv_shapes)
        phase_celeba_graph(celeba_cfg, bf16)
        del bf16
        by_path.update(_timed("celeba-sample", phase_celeba_sample, model, tmp))
        del model
        by_path["celeba_train"] = phase_celeba_train(celeba_cfg)
        by_path["celeba_train_f32"] = _timed("train-f32", phase_train_f32, celeba_cfg,
                                             gate_img_per_s)
        phase_remat(celeba_cfg, card)
        torch.cuda.empty_cache()
        by_path.update(phase_dist(tmp, ckpt, card))
        by_path.update(phase_mp(tmp, ckpt, card))
    phase_bench()

    meta = {
        # B1 and B3 in bf16, the paths' type: attn_fwd_tc.cu (their f32 calls,
        # attn_fwd_tf32.cu, have records of their own below)
        "attn_fwd_online": ("vdiff_tpu_torch/csrc/attn_fwd_tc.cu",
                            "vdiff_tpu/ops/attention.py:37"),
        # B2 and B5 in bf16, the paths' type: the tensor-core kernels (B2's
        # f32 calls, attn_fwd_tf32.cu, are attn_fwd_qblk's record below; B5's
        # f32 calls run attn_bwd_tf32.cu's pair, attn_bwd_rows / attn_bwd_cols)
        "attn_fwd_tc": ("vdiff_tpu_torch/csrc/attn_fwd_tc.cu",
                        "vdiff_tpu/ops/attention.py:224"),
        "attn_bwd_tc": ("vdiff_tpu_torch/csrc/attn_bwd_tc.cu",
                        "vdiff_tpu/ops/attention.py:240"),
        "attn_fwd_train": ("vdiff_tpu_torch/csrc/attn_fwd_tc.cu",
                           "vdiff_tpu/ops/attention.py:184"),
        # B4 in bf16: attn_bwd_tc.cu (its f32 calls: attn_bwd_tf32.cu's pair,
        # the records attn_bwd_rows / attn_bwd_cols below)
        "attn_bwd": ("vdiff_tpu_torch/csrc/attn_bwd_tc.cu",
                     "vdiff_tpu/ops/attention.py:204"),
        # B6-B9 in bf16, the paths' type, the tensor-core kernels:
        # attn_fwd_tc.cu and its lse entry, attn_bwd_tc.cu and its
        # saved-statistics entry (f32 calls: attn_fwd_tf32.cu and its lse
        # entry, attn_bwd_tf32.cu's pair and its saved-statistics entry, the
        # *_f32 records below); each counted apart
        "attn_fwd_pack1": ("vdiff_tpu_torch/csrc/attn_fwd_tc.cu",
                           "vdiff_tpu/ops/attention.py:318"),
        "attn_fwd_pack1_lse": ("vdiff_tpu_torch/csrc/attn_fwd_tc.cu",
                               "vdiff_tpu/ops/attention.py:407"),
        "attn_bwd_pack1": ("vdiff_tpu_torch/csrc/attn_bwd_tc.cu",
                           "vdiff_tpu/ops/attention.py:470"),
        "attn_bwd_pack1_kv": ("vdiff_tpu_torch/csrc/attn_bwd_tc.cu",
                              "vdiff_tpu/ops/attention.py:567"),
        # B10: one launch that reads x once (both dtypes); B11: the
        # statistics pass of gn_common.cuh, then in bf16 the tensor-core conv
        # (f32 keeps gn_silu_conv3x3.cu, off these paths)
        "gn_film_silu_kernel": ("vdiff_tpu_torch/csrc/gn_film_silu.cu",
                                "vdiff_tpu/ops/groupnorm.py:79"),
        "fused_gn_silu_conv3x3": ("vdiff_tpu_torch/csrc/gn_silu_conv3x3_tc.cu",
                                  "vdiff_tpu/ops/conv3x3.py:58"),
        # B1 and B2 in f32, the eval path's type (its f32 UNet, as JAX's
        # compute_nll runs it): the 3xTF32 tensor-core forward
        "attn_fwd_online_f32": ("vdiff_tpu_torch/csrc/attn_fwd_tf32.cu",
                                "vdiff_tpu/ops/attention.py:37"),
        "attn_fwd_qblk": ("vdiff_tpu_torch/csrc/attn_fwd_tf32.cu",
                          "vdiff_tpu/ops/attention.py:224"),
        # B6 in f32, celeba's nll: the same kernel under attn_fwd_pack1's count
        "attn_fwd_pack1_f32": ("vdiff_tpu_torch/csrc/attn_fwd_tf32.cu",
                               "vdiff_tpu/ops/attention.py:318"),
        # B3, B4 and B5 in f32, the default train CLI and the quality gate's
        # train stage: the same forward, and the 3xTF32 row and column
        # kernels of the backward (B5's T=1024 calls run the same pair)
        "attn_fwd_train_f32": ("vdiff_tpu_torch/csrc/attn_fwd_tf32.cu",
                               "vdiff_tpu/ops/attention.py:184"),
        "attn_bwd_rows": ("vdiff_tpu_torch/csrc/attn_bwd_tf32.cu",
                          "vdiff_tpu/ops/attention.py:204"),
        "attn_bwd_cols": ("vdiff_tpu_torch/csrc/attn_bwd_tf32.cu",
                          "vdiff_tpu/ops/attention.py:204"),
        # B7, B8 and B9 in f32, celeba's default f32 train step: attn_fwd_tf32.cu's
        # lse entry, attn_bwd_tf32.cu's pair and its saved-statistics entry
        "attn_fwd_pack1_lse_f32": ("vdiff_tpu_torch/csrc/attn_fwd_tf32.cu",
                                   "vdiff_tpu/ops/attention.py:407"),
        "attn_bwd_pack1_f32": ("vdiff_tpu_torch/csrc/attn_bwd_tf32.cu",
                               "vdiff_tpu/ops/attention.py:470"),
        "attn_bwd_pack1_kv_f32": ("vdiff_tpu_torch/csrc/attn_bwd_tf32.cu",
                                  "vdiff_tpu/ops/attention.py:567"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        paths = {path: counts.get(name, 0) for path, counts in by_path.items()
                 if counts.get(name, 0)}
        if not paths:
            fail(f"{name} was not launched on the main path")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": sum(paths.values()), "launches_by_path": paths,
                        **record[name]})
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--gloo-ddp"]:  # a rank of the dist phase's part (d)
        gloo_ddp_worker()
    elif sys.argv[1:2] == ["--dist-clis"]:  # the rank of parts (a)-(c)
        dist_clis_worker(*sys.argv[2:5])
    elif sys.argv[1:2] == ["--mp"]:  # a rank of the mp phase
        mp_worker(*sys.argv[2:4])
    else:
        main()
    sys.stdout.flush()
