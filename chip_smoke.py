#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ecoflap_tpu_torch``) on one card.

Run from the root of a checkout:  python3 chip_smoke.py
(``--kernels-only`` stops after phase 3: the kernels' build, checks and
times, without the prune paths and without the final result lines).

Phases, in order; any failure raises and the exit code is non-zero:
  1. device line, toolkit versions, and the build of every CUDA source;
  2. each kernel against its plain PyTorch version on the card: the
     perturbation kernels (in place and out of place) at the BLIP-2
     FlanT5-XL weight shapes plus a ragged one, the in-place one also at
     the LLaMA-7B shapes of phase 5, in bf16 and f32; the causal
     flash-attention forward (with and without its LSE output) and backward
     kernels at the LLaMA calibration shape, phase 13's window at batch 1,
     a short one and one whose last 128-row tile is half full (S % 128 == 64), their causality, strided
     inputs, the backward's determinism, and refusals of what they do not
     take; the SparseGPT sweep kernel against ``_sweep_block`` bit for bit
     (``SWEEP_CASES``: one and several lanes, unstructured and n:m, the
     ViT-g and T5 row counts, a ragged block, a NaN lane, tied saliences,
     float64);
  3. kernel timing (CUDA events) beside each kernel's bound, its plain
     version and, where one exists, the PyTorch library call;
  4. the BLIP-2 path: ``ecoflap_tpu_torch.cli.prune.main`` prunes BLIP-2
     FlanT5-XL at full width and depth (random bf16 weights, seed 42) with
     the ECoFLaP zeroth-order + Wanda flags of scripts/blip2/ecoflap_zeroth.py
     at the zeroth_pb shape, scoring by the lane ensemble (the default: the
     out-of-place perturbation kernel), counting kernel launches;
  5. the LLaMA path: the same entry point prunes LLaMA-7B at full width and
     depth with the flags of scripts/llama/ecoflap_zero.sh, except 64
     calibration windows in microbatches of 4 and one coarse microbatch of 4
     windows (the reference prunes on 128 and scores 32; cut for time from
     128 windows in microbatches of 8), calibrated by ``--calib`` on a
     C4-style jsonl written here (the CLI's file branch: each document
     tokenized with EOS, one stream, windows of it), scoring by
     the serial in-place cycle (LLaMA's default: the in-place perturbation
     kernel), counting kernel launches; then, on the CPU, the CLI's windows
     checked against the file's stream and a file too short for them
     ending the run with the JAX CLI's message;
  6. the LLaMA first-order path: LLaMA-7B at full width and depth with the
     same flags, ``--calib synthetic`` and ``--score_method GradOnly_sum`` (the reference
     LLaMA/main.py without --use_mezo), all 32 coarse windows (8
     microbatches of 4), counting kernel launches: every block's backward runs
     the flash backward kernels;
  7. the BLIP-2 first-order path: BLIP-2 FlanT5-XL with the flags of
     scripts/blip2/ecoflap_first.py (GradMagAbs_sum), cut to 32 coarse
     samples (the reference scores 128), counting kernel launches (none);
  8. the BLIP-2 SparseGPT path: BLIP-2 FlanT5-XL with the flags of
     scripts/blip2/ecoflap_sparsegpt_zeroth.py and ``--sparsity_dict`` of
     phase 4's YAML (no coarse stage; one sweep kernel launch a column
     block of each weight group, counted), each block's zero share against
     its ratio, the fine stage's wall split per stack; then ViT-g block 0 at
     the same init and calibration, pruned by SparseGPT on the card and on
     the CPU from one float32 Hessian: the Hessians' conditioning and the
     two sides' reconstruction errors, and on the card the prune through the
     sweep kernel against the prune through ``_sweep_block``, bit for bit;
  9. the port on the card against the port on the CPU: tiny BLIP-2 in f32,
     and a small LLaMA in bf16 on the card (flash kernels) against f32 on
     the CPU (plain attention): logits, losses and first-order sums, the
     sums twice on the card (the same bits: they feed the allocator); on
     the card in f32, the lane ensemble against the serial path with the
     same seeds on a small BLIP-2 and the small LLaMA, and a ``shared``
     noise run; tiny BLIP-2 SparseGPT on the card against the CPU; and the
     global-mask baselines and their options: tiny BLIP-2 global magnitude,
     |W| |G| and MeZO (one seed, kernel 1 counted), ``--coarse_only`` with
     ``Real-GradMagAbs_sum``, ``layer`` and ``--prune_per_model`` (both
     sides from one ``--ckpt``), SparseGPT with ``--hessian_bf16``,
     ``llama_magnitude_pruner``, and the small LLaMA's ``Real-GradMagAbs``
     coarse stage in bf16 (flash kernels, counted) against f32 on the CPU;
 10. the BLIP-2 global magnitude path: BLIP-2 FlanT5-XL at full width and
     depth with the flags of scripts/blip2/mag.py and ``--save_pruned_model``,
     counting kernel launches (none); then the ``.pth`` (float32, reference
     names) loaded through the ``--ckpt`` loader into a freshly built XL
     model, tensor by tensor equal to the pruned one, and deleted;
 11. the BLIP-2 global |W| |G| path: the flags of
     scripts/blip2/iterative_global_gradient.py (3 steps of 8 backward
     microbatches), counting kernel launches (none), and three full-loss
     forwards timed for the global MeZO baseline's estimate;
 12. the BLIP-2 evaluation path: ``ecoflap_tpu_torch.cli.evaluate.main``
     evaluates BLIP-2 FlanT5-XL at full width and depth on synthetic VQA (3
     batches of 8, beam 5, 10 new tokens, length penalty -1: the
     reference's VQA decode point, blip2_t5.py:420-428), counting kernel
     launches (none: BLIP-2's attention is naive); then the same weights
     (the seed's) through ``Blip2T5.generate`` on batch 0 at that point
     and at the captioning point (beam 5, 30 tokens, length penalty 1.0):
     valid ids and pad after each row's first EOS, in the tokens of the
     CLI's three batches too, batch 0 the same in the CLI and three times
     on the rebuilt model, the decode loop's ms per step beside its
     weight-read bound, its CUDA launches and device time per step
     (profiler), and the peak;
 13. the LLaMA evaluation path: the same entry point's WikiText perplexity
     of LLaMA-7B at full width and depth (the JAX CLI's synthetic stream:
     one window of 2048, one forward at batch 1), then 64 windows through
     the same task and ``Runner.evaluate`` at batch 8; finite, one flash
     forward launch per block and forward, no other kernel;
 14. the standalone FlanT5-XL path: the prune CLI with ``--cfg-path
     t5/c4_prefix_derivative_compute.yaml`` (scripts/t5/ecoflap.py's flags:
     t5_wanda_pruner, MEZO-GradOnly_avg, cap 0.6) cut by ``--options`` to
     one coarse microbatch of 8 (the reference scores 128), every target by
     the serial in-place cycle (kernel 1), then its ``.pth`` read back
     tensor by tensor into a fresh XL model;
 15. FlanT5-XL MMLU: the evaluate CLI's synthetic branch at full width, then
     57 subjects x 8 questions (5 shots) through ``MMLUTask`` and
     ``Runner.evaluate`` at the task's 2,048-token budget (no prompt cut),
     twice, with the same predictions;
 16. the EVA-CLIP-g path: ``--cfg-path eva_clip/ecoflap.yaml``
     (scripts/eva_clip/ecoflap.py's flags) cut to two coarse microbatches,
     the visual tower's 160 targets by the serial cycle, its ``.pth`` (39
     blocks) read back; then zero-shot classification of the pruned model
     at full width: a classifier over 1,000 synthetic class names x the 80
     OpenAI templates, 8 batches of 32 images through the task and
     ``Runner.evaluate``;
 17. the CLIP ViT-B/16 path: scripts/coop/ecoflap_wanda.sh's second loop,
     uncut (96 targets, 4 coarse microbatches of 16), then zero-shot
     classification with the ImageNet CoOp template;
 18. the BLIP-1 caption path, the UPop run: ``ecoflap_tpu_torch.cli.upop``
     (scripts/upop/ecoflap_caption.py's flow) on BLIP-1 with ViT-B/16 at 384
     px and the 12-layer BERT decoder (random bf16 weights, seed 42): 16
     samples in 2 coarse microbatches (cut from the launcher's 32 in 4),
     p = 0.5, the ViT's 48 targets by the full loss and the decoder's 120 by
     its LossPlan, all by the serial in-place cycle (kernel 1, 1,008
     launches),
     then 2 masked AdamW steps (every pruned entry stays 0) and the pruned
     ``.pth``, read back tensor by tensor; then the evaluate CLI's blip1
     captioning from that ``.pth`` (2 batches of 8, beam 3, 20 tokens);
 19. the DeiT-B path: scripts/llama/image_classifiers.sh's flags (128
     samples at batch 16, deit_wanda_pruner, 12-0.5-1.0-1.0) through the
     prune CLI from a timm-named ``--ckpt`` of the seed's weights with the
     head scaled 16x (see ``DEIT_HEAD_SCALE``) (Wanda, no kernel launch),
     then again with the ECoFLaP block MeZO stage (cap 0.6,
     32 coarse samples: 48 targets x 2 microbatches x 3 = 288 kernel-1
     launches; at least half the scores non-zero, in at least 4 values)
     and ``--save_pruned_model``; the ``.pth`` read back tensor by tensor,
     then top-1 on random images from it through the evaluate
     CLI;
 20. the ConvNeXt-T path: the same with convnext_wanda_pruner and
     0-0.5-1.0-1.0, from an FB-named ``--ckpt`` whose layer scales are drawn
     from U(0.5, 1.5) (the init's 1e-6 leaves every block a bf16 rounding of
     its residual): 36 targets, 216 kernel-1 launches;
 21. BLIP-2 OPT-2.7B captioning (EVA ViT-g 39 x 1408, the Q-Former,
     OPT-2.7B 32 x 2560; random bf16 weights, seed 42) through the evaluate
     CLI: 2 batches of 8 random images, the prompt "a photo of", beam 5, 10
     new tokens, min length 8 (caption_coco_opt2.7b_eval.yaml); every id in
     the vocabulary, pad after EOS, every caption at least 8 tokens with its
     prompt, finite metrics; then batch 0's decode loop alone (the CLI's
     tokens again) against its weight-read bound, with its launches and
     device time a step (profiler), and the peak;
 22. the stage-1 Q-Former's retrieval through the evaluate CLI at tiny on
     the card and on the CPU from one model: equal recall metrics; then
     ``--model_scale full``, which ends with the JAX CLI's message.
Phase 9 also holds tiny BLIP-2's generated tokens (f32, greedy and beam 5
at the VQA and captioning points) on the card against the CPU; tiny BLIP-2
in bf16 with rows that finish: the decode step's float32 logits on the card
against the CPU's, and the card's tokens' validity; the small LLaMA's
bf16 perplexity on the card (flash kernel) against f32 on the CPU; and, in
f32, tiny standalone T5's zeroth-order and SparseGPT masks (SparseGPT on
random ids, then on the CLI's own batch: the flip share read, encoder block
0 from one Hessian in f32 and f64), tiny CLIP's and
EVA-CLIP's contrastive losses and zero-shot logits, and tiny T5's MMLU
first-token logits, card against CPU; tiny BLIP-1's four heads (f32,
kernels 10x the init): the per-sample loss and the UPop launcher's
sparsity dict and masks from one ``--ckpt`` (kernel 1 on the card), card
against CPU; and tiny DeiT's and ConvNeXt's logits and CE losses, tiny
BLIP-2 OPT's greedy and beam-5 tokens and tiny Q-Former retrieval's ITC
similarities and ITM logits, card against CPU (f32). Phase 2 also holds the in-place kernel at CLIP ViT-B/16's
eight weight shapes (BLIP-1's and DeiT-B's are among them) and at
ConvNeXt-T's. Kernel
launch counts are set to 0 just before each of phases 4 to 8 and 10 to 23
(phases 18-20: each prune, then the eval) and read just after it. Phase 23
(the mesh on the card): with torchrun's variables for one rank, an NCCL
group of world size 1 and phase 19's DeiT-B ECoFLaP run through the prune
CLI with ``--mesh dp=1,tp=1``, its dict and ``.pth`` bit-identical to phase
19's and 288 kernel-1 launches; then ``torch.distributed.run
--nproc-per-node 1`` of the evaluate CLI with ``--mesh dp`` on that
``.pth`` with its head planted (phase 19's images' predictions set to their
labels for every other image: top-1 exactly 50.0); then each tp rank of
``models/layers.linear`` run in turn at LLaMA-7B's q_proj and down_proj
shapes in bf16 at tp 2 and 4, the ranks' collectives joined as NCCL joins
them, each within 1 bf16 ulp of the unsharded product (an output under 1/64
of the product's RMS counted at that magnitude: there the sum cancels, and
two float32 orders differ by more than its ulp). The line before the last holds the card's
``name, power.limit``; the last is ``{"ok": true, "device": {...}}``.
"""

import argparse
import contextlib
import copy
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
# per Philox counter (four elements): 10 rounds of 2 32x32->64 multiplies (4
# ops) and 4 XORs, its round keys from the host; per word pair (two
# elements): 2 shifts, 2 int->float, 2 scalings, a clamp, log, a product,
# sqrt, the angle's product, cos, sin and 2 products; per element: scale*z
# and the add
PERTURB_OPS_PER_ELEMENT = (10 * 8 + 2 * (2 + 13) + 4 * 2) / 4
# the same function counted for a stream of one element per Philox call with
# the key schedule run per element (printed once, for comparison)
PERTURB_OPS_ONE_ELEMENT_PER_CALL = 10 * 8 + 9 * 2 + 2 + 13
XL_SHAPES = [(4224, 1408), (1408, 1408), (6144, 1408), (1408, 6144),
             (2048, 2048), (5120, 2048), (2048, 5120)]
RAGGED = (301, 577)
# a (3, 301, 577) leaf: leaf[1] starts 173,677 elements in, off any 16-byte
# boundary and at an odd element (kernel: scalar head, odd-phase vectors)
RAGGED_LEAF = (3, *RAGGED)
# the out-of-place kernel runs every lane of the BLIP-2 ensemble
OUT_OF_PLACE_SHAPES = XL_SHAPES + [RAGGED]
# LLaMA-7B target shapes per block: q, k, v, o; gate, up; down
LLAMA_SHAPES = [(4096, 4096)] * 4 + [(11008, 4096)] * 2 + [(4096, 11008)]
# CLIP ViT-B/16's target shapes (out, in) per block: the visual resblocks'
# in_proj, out_proj, c_fc and c_proj at width 768, the text tower's at 512
CLIP_SHAPES = [(2304, 768), (768, 768), (3072, 768), (768, 3072),
               (1536, 512), (512, 512), (2048, 512), (512, 2048)]
# ConvNeXt-T's target shapes (out, in): pwconv1 and pwconv2 of each block,
# depths 3-3-9-3 at widths 96-192-384-768 (DeiT-B's are CLIP ViT-B/16's
# visual four)
CONVNEXT_DEPTHS, CONVNEXT_DIMS = (3, 3, 9, 3), (96, 192, 384, 768)
CONVNEXT_SHAPES = [s for d, c in zip(CONVNEXT_DEPTHS, CONVNEXT_DIMS)
                   for s in [(4 * c, c), (c, 4 * c)] * d]
# the in-place kernel runs the serial cycles of phases 5 (LLaMA-7B), 14
# (FlanT5-XL, BLIP-2's T5 shapes), 16 (EVA-CLIP-g, BLIP-2's ViT shapes), 17
# (CLIP ViT-B/16), 18 (BLIP-1: CLIP ViT-B/16's visual shapes), 19 (DeiT-B:
# the same) and 20 (ConvNeXt-T), and BLIP-2's that --mezo_ensemble 0 selects
IN_PLACE_SHAPES = (XL_SHAPES + sorted(set(LLAMA_SHAPES)) + CLIP_SHAPES
                   + sorted(set(CONVNEXT_SHAPES) - set(CLIP_SHAPES)) + [RAGGED])
LLAMA_LINEARS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                 "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")
SEED = 42
BATCH_SIZE = 8
NUM_SAMPLES = 128
NUM_DATA_FIRST_STAGE = 32
LLAMA_LAYERS = 32
LLAMA_SEQLEN = 2048
# phases 5-6 (LLaMA-7B) calibrate on 64 windows in microbatches of 4 and
# score one coarse microbatch of 4 windows zeroth-order (the reference
# scores 32 windows and prunes on 128, at batch 1), cut from 128 windows in
# microbatches of 8, whose compute-bound suffix forwards took 124 s, to keep
# the run inside half its limit
LLAMA_BATCH = 4
LLAMA_SAMPLES = 64
LLAMA_FIRST_STAGE = 4  # one coarse microbatch
LLAMA_FO_FIRST_STAGE = 32  # the first-order path scores all 32, as the reference
BLIP2_FO_FIRST_STAGE = 32  # the reference's ecoflap_first.py scores 128
Z_ULP_TOL = 4  # CUDA logf/cosf vs PyTorch's: a few ulp at most
BF16_MISMATCH_SHARE = 1e-4  # bf16 outputs a z ulp away from a rounding tie
# (B, H, S, Dh): phase 13's batches of 8 windows of LLaMA-7B (the timed
# shape), the coarse and fine chunk shape of phases 5-6, phase 13's one
# window at batch 1 (the evaluate CLI's synthetic stream), a short one, and
# one whose last 128-row tile is half full (S % 128 == 64: the tensor maps'
# bounds zero-fill it and its rows past S are never stored)
FLASH_SHAPES = [(8, 32, 2048, 128), (4, 32, 2048, 128), (1, 32, 2048, 128),
                (1, 32, 512, 128), (2, 8, 576, 128)]
# kernel (bf16 out) vs plain version (float32 throughout, one rounding to
# bf16). The output rounding alone is half a bf16 ulp, 2^-9 relative, on
# either side, so two roundings can sit one ulp (2^-8 = 3.9e-3 relative)
# apart; the kernel also rounds P to bf16 before P V, a relative error of
# at most 2^-9 per term that averages out over the keys. So: at most 2e-2
# of max(1, |plain|), five bf16 ulps, per element; and a mean |error| of
# 2e-3, a fraction of one ulp at the outputs' typical size (|o| < 1).
FLASH_MAX_REL = 2e-2
FLASH_MEAN_ABS = 2e-3
# small LLaMA, bf16 on the card vs f32 on the CPU. Logits: each of ~20
# roundings per block (weights included) is at most 2^-9 = 2e-3 relative,
# and they add up as a random walk, so the relative L2 error of the logits
# sits near 1e-2. The embeddings are N(0, 0.02) and every block adds O(1),
# so the logits are what attention and the MLPs make of them: a kernel that
# attends to the wrong keys moves them by O(1). Loss: it sits near ln(512)
# whatever the logits are, so it only guards the loss tail, at a few times
# the error measured on the H100 (1.4e-4).
LLAMA_LOGITS_REL = 3e-2
LLAMA_LOSS_RTOL = 1e-3
# flash backward kernels (bf16 out) vs plain version (float32 throughout,
# one rounding to bf16). Per element the output rounding alone can put the
# two one bf16 ulp apart (2^-8 relative, 0.0156 at |g| in [2, 4)), and the
# gradients' largest entries are of that size: so the forward's 2e-2 of
# max(1, |plain|). Most entries are far smaller (RMS ~0.08 at N(0, 1)
# inputs), so a relative L2 gate carries the check: the kernels round P and
# dS to bf16 before their products (2^-9 relative per term, independent
# over the 64-2048 terms of a sum) and round each output once more, about
# 3e-3 in all; 1e-2 leaves 3x. The LSE is float32 on both sides, the same
# scores summed in another order and through exp2/log2: 1e-4 absolute on
# values up to ~10 is some 100 float32 ulps.
FLASH_BWD_MAX_REL = 2e-2
FLASH_BWD_REL_L2 = 1e-2
FLASH_LSE_MAX_ABS = 1e-4
# small LLaMA first-order GradOnly sums, bf16 card vs f32 CPU: each sum adds
# |g| over 65,536-176,128 entries, which averages the per-entry bf16 error
# (of the order of the logits' 1e-2) down to its systematic part; that part
# comes from the same roundings and is a fraction of it. A backward that
# attends to the wrong keys or drops sm_scale moves the attention weights'
# sums by O(1).
LLAMA_GRAD_SUMS_RTOL = 1e-2
# lane ensemble vs serial cycle on the card, float32, the same z: a score is
# |L+ - L-| / 2eps summed over 2 microbatches. The losses (~10 at a 32k
# vocabulary, ~6 at 512) come from GEMMs that cuBLAS may block differently
# at K x B rows than at B rows, and the serial cycle restores each weight to
# one rounding: a few float32 ulps (~1e-6) per loss, 1e-5 at the most, over
# 2 eps = 0.1 gives 1e-4 per microbatch. 1e-3 beyond rtol 1e-3 leaves 5x; a
# lane that perturbs another weight, or with another z, moves a score by
# O(1).
ENSEMBLE_EPS = 0.05
ENSEMBLE_RTOL = 1e-3
ENSEMBLE_ATOL = 1e-3
# BLIP-2 XL SparseGPT: a block's linears share its ratio, and the sweep
# prunes floor(n sp) entries of each 128-column block plus its ties, so a
# block's zero share sits within a few 1e-4 of its ratio; a block pruned to
# another ratio, or a lane zeroed whole, misses 0.01 by far.
SPARSEGPT_BLOCK_TOL = 0.01
# tiny BLIP-2 SparseGPT, card vs CPU, float32 (TF32 off): the Cholesky
# factors and products come from cuSOLVER/cuBLAS on one side and LAPACK on
# the other; on these Hessians (eigenvalue ratios above 2e-5) the port
# differs from the JAX package on the CPU by at most 1.5e-5 absolute
# (tests/test_torch_sparsegpt_pipeline.py), so the relative L2 of the pruned
# weights sits near 1e-5: gate 1e-3. A mask entry that flips moves its
# weight by O(1e-1); at most one in a thousand may sit on a near-tie.
SPARSEGPT_REL_L2 = 1e-3
SPARSEGPT_MASK_SHARE = 1e-3
# ViT-g block 0 at phase 8's init, SparseGPT card vs CPU from one float32 H:
# the Hessians' eigenvalue ratios go down to ~6e-7 (qkv: a LayerNorm with
# zero bias leaves its outputs' sum near 0, only bf16 rounding off it) and
# the sweep factors H undamped, so Hinv is large along the near-null
# directions and the two libraries' pruned weights part there (on the
# H100: 17% of qkv's mask, relative L2 0.68; PERF.md). The objective
# tr(D H D^T) barely sees those directions: the two sides agreed to 1.0e-2
# relative on qkv, 9e-4 on fc1 and below 1e-5 on proj and fc2. Gate 3e-2,
# 3x that; the mask without the sweep's updates sits 2-3.5x above the
# sweep's objective, so a lost or misdirected update fails one gate or the
# other.
SPARSEGPT_XL_RECON_RTOL = 3e-2
SPARSEGPT_STACKS = ("visual_encoder.blocks", "t5_model.encoder.block",
                    "t5_model.decoder.block")
# phases 10-11, scripts/blip2/mag.py and iterative_global_gradient.py: every
# target pruned by one global threshold, 3 steps of the schedule
GLOBAL_SPEC = "24-0.5-1.0-1.0"
GLOBAL_ITERATIONS = 3
GLOBAL_SCORED = 64  # the global pruners' default num_samples (cli/prune.py:674-680)
# global magnitude at XL: the mask prunes int(0.5 N) entries plus the rest of
# the threshold's tie class, and at a random bf16 init one bf16 magnitude
# near the median holds about 0.3% of all weights
GLOBAL_MAG_SPARSITY = (0.500, 0.505)
# |W| |G| is a float32 product: ties are rare
GLOBAL_GRAD_SPARSITY = (0.500, 0.501)
# tiny BLIP-2 global |W| |G|, card vs CPU, float32: the importances differ
# by float32 rounding (the gradients' reduction order), so an entry flips
# only within a near-tie of the threshold: at most 1e-3 of the entries over
# 3 steps, and in one step only entries within 1e-3 relative of it
GLOBAL_GRAD_MASK_SHARE = 1e-3
GLOBAL_NEAR_TIE = 1e-3
# Real-GradMagAbs zero shares, tiny BLIP-2 in f32, card vs CPU: each flip of
# a near-tie moves one target's share by 1/numel; at most 1e-3 of all
# entries may flip (the |W| |G| gate above)
REAL_F32_FLIP_SHARE = 1e-3
# small LLaMA Real-GradMagAbs, bf16 on the card vs f32 on the CPU: the
# importances carry the bf16 error of the gradients (the GradOnly sums'
# 1e-2, per entry more), so the entries within ~1e-2 of each step's
# threshold may fall either side, some 1-2% of a tensor at these densities
REAL_BF16_SHARE_TOL = 3e-2
# tiny SparseGPT with --hessian_bf16, card vs CPU: where the two float32
# Gram sums straddle a bf16 rounding boundary, an H entry differs by one
# bf16 ulp (2^-8 relative). In the first block, whose inputs agree to
# float32 rounding, that moved the pruned weights by up to 3.2e-4 relative
# L2 with equal masks (the port against the JAX package on the CPU, tests/
# test_torch_granularity.py): masks equal, 1e-3. Later blocks inherit the
# difference through their inputs and their near-singular tiny Hessians
# amplify it: the whole tiny BLIP-2 came out 8.5e-2 apart in relative L2
# with 3.7e-3 of the mask entries flipped, port against JAX on the CPU, so
# the whole model's masks are held within 1e-2 and its weights reported
SPARSEGPT_BF16_FIRST_REL_L2 = 1e-3
SPARSEGPT_BF16_MASK_SHARE = 1e-2
# phases 12-13, the evaluation paths: the reference's decode points
# (blip2_t5.py:420-428 VQA predict_answers, :352-364 captioning) and the JAX
# CLI's synthetic sizes (cli/evaluate.py: 3 batches separate the first from
# the steady rate; a stream of 64 x 32 tokens)
EVAL_BATCHES = 3
VQA_POINT = dict(max_new_tokens=10, num_beams=5, length_penalty=-1.0)
CAPTION_POINT = dict(max_new_tokens=30, num_beams=5, length_penalty=1.0)
EVAL_STREAM_TOKENS = 64 * 32
# phase 13's second stream, through Runner.evaluate and PerplexityTask: 64
# windows of 2048, eight forwards at batch 8 (the reference evaluates the
# whole WikiText-2 test split, whose text and tokenizer are not in the repo)
EVAL_PPL_WINDOWS = 64
# tiny BLIP-2's EOS row of the lm_head raised by this much: most rows then
# finish before the last step, so beam search's finished set is exercised
EOS_BOOST = 0.3
# tiny BLIP-2 in bf16, the decode step's float32 logits on the card against
# the CPU's from the same encoder output and tokens. Both sides take the same
# bf16 values and sum each product in float32, in another order. At tiny T5's
# widths (32 and 64 terms a sum) a product of two bf16 values is exact in
# float32 and so are most of the sums, so the two sides round alike to bf16
# and part only at float32 rounding: 5.1e-8 relative L2 on the H100 (NVIDIA
# H100 80GB HBM3, 700.00 W). The gate is 1e-3, set from that reading: a sum
# rounded to bf16 one ulp apart moves the logits by a few 1e-4, while a bf16
# lm_head product (logits rounded to bf16: 2^-9 relative, 1.1e-3 RMS) or a
# step that attends to the wrong cache rows moves them further (a logit
# rounded to bf16 also fails the float32 check of the step).
BF16_STEP_LOGITS_REL = 1e-3
# phases 14-17: standalone FlanT5-XL, EVA-CLIP-g and CLIP ViT-B/16, with the
# project YAMLs of their launchers where the repo has one
T5_CFG_PATH = "t5/c4_prefix_derivative_compute.yaml"
T5_FIRST_STAGE = 8  # one coarse microbatch of the YAML's 8; the reference scores 128
T5_TARGETS = 24 * 7 + 24 * 11
EVA_CFG_PATH = "eva_clip/ecoflap.yaml"
EVA_FIRST_STAGE = 16  # two coarse microbatches of the YAML's 8
EVA_TARGETS = 40 * 4
CLIP_SAMPLES = 64  # scripts/coop/ecoflap_wanda.sh: 64 samples at batch 16, all scored
CLIP_BATCH = 16
CLIP_TARGETS = 2 * 12 * 4
# phase 15: the MMLU harness's 57 subjects, 8 test questions each, 5 shots
MMLU_TEST_PER_SUBJECT = 8
MMLU_SHOTS = 5
MMLU_MAX_TOKENS = 2048  # crop_prompt's budget: no prompt reaches it
# word counts of the synthetic questions and choices: 5-shot prompts of some
# hundreds of tokens, as MMLU's run
MMLU_QUESTION_WORDS = (10, 90)
MMLU_CHOICE_WORDS = (1, 15)
# phases 16-17: zero-shot classification over synthetic class names
ZS_CLASSES = 1000
ZS_BATCHES = 8
ZS_BATCH = 32
# peak device memory of each new prune path, GiB: the bf16 weights (FlanT5-XL
# 5.3, EVA-CLIP-g 2.1, CLIP 0.3) and the stacks' calibration activations
# with a few GiB to spare; a leak of a model copy or of per-target buffers
# crosses them
T5_PEAK_GIB = 16.0
EVA_PEAK_GIB = 16.0
CLIP_PEAK_GIB = 8.0
# phase 9, the new families at tiny widths, f32, card vs CPU (TF32 off):
# the same float32 operations in another order part by a few ulps (1e-6
# relative) per value, through 2-4 blocks; 1e-3 relative L2 leaves a wide
# margin and still fails on a wrong mask, bias, activation or pooling,
# which move these values by O(1e-1). The MeZO scores (eps 0.05) differ by
# the kernel's and the plain version's z (a few ulps) and the losses' float32
# rounding: their sparsity dicts are held to 1e-3 relative, and a mask entry
# may flip only at a near-tie, at most 1e-3 of all (as SparseGPT's masks).
NEW_FAMILY_REL_L2 = 1e-3
NEW_FAMILY_DICT_RTOL = 1e-3
NEW_FAMILY_MASK_SHARE = 1e-3
# phase 18, the UPop caption run (scripts/upop/ecoflap_caption.py's flow
# through cli/upop.py): BLIP-1 with ViT-B/16 at 384 px and the 12-layer BERT
# decoder, bf16, p = 0.5 (cap 0.6), 2 masked AdamW steps, then captioning
# from the pruned .pth at blip_caption's generate defaults (beam 3, 20
# tokens), 2 batches of 8. Its samples are cut to 16 in 2 coarse
# microbatches of 8 (the launcher's default: 32 in 4) to keep the run inside
# half its limit
BLIP1_SAMPLES = 16
BLIP1_MICROBATCH = 8
BLIP1_TARGETS = 12 * 4 + 12 * 10
BLIP1_FT_STEPS = 2
BLIP1_EVAL_BATCHES = 2
BLIP1_CAPTION_POINT = dict(max_new_tokens=20, num_beams=3, length_penalty=1.0)
# 0.45 GB of bf16 weights, AdamW's two moments 0.9 GB more, and the
# fine-tune step's saved activations at 32 x 577 ViT tokens: the naive
# attention keeps each block's (32, 12, 577, 577) probabilities, some 0.5-1
# GB a block; a leak of a model copy or of the coarse stage's per-target
# buffers crosses it
BLIP1_PEAK_GIB = 24.0
# (out, in) of its targets per block: ViT-B/16's qkv, proj, fc1, fc2 (CLIP
# ViT-B/16's visual shapes); the BERT decoder's 8 of 768 x 768 (self and
# cross query, key, value, output), intermediate and output
BLIP1_SHAPES = (CLIP_SHAPES[:4] * 12
                + ([(768, 768)] * 8 + [(3072, 768), (768, 3072)]) * 12)
# phase 9's tiny BLIP-1 heads: at the init (std 0.02) a MeZO perturbation
# moves their loss by a few float32 ulps, so the kernels are scaled 10x and
# eps is 0.2, as tests/test_torch_blip1.py holds them against the JAX package
BLIP1_TINY_KERNEL_SCALE = 10.0
BLIP1_TINY_EPS = 0.2
BLIP1_TINY_SAMPLES = 8
# phases 19-20, scripts/llama/image_classifiers.sh's flags (128 samples at
# batch 16, spec 12- or 0-0.5-1.0-1.0), then the ECoFLaP block MeZO stage on
# 32 of them (2 coarse microbatches), cap 0.6
CLS_SAMPLES = 128
CLS_BATCH = 16
CLS_FIRST_STAGE = 32
CLS_NAMES = {"deit": "DeiT-B", "convnext": "ConvNeXt-T"}
CLS_SPECS = {"deit": "12-0.5-1.0-1.0", "convnext": "0-0.5-1.0-1.0"}
CLS_ECOFLAP = ["--sparsity_ratio_granularity", "block", "--score_method",
               "MEZO-GradOnly_sum", "--max_sparsity_per_layer", "0.6",
               "--num_data_first_stage", str(CLS_FIRST_STAGE)]
# kernel-1 launches: 3 per target and coarse microbatch; the targets are
# attn.qkv, attn.proj, mlp.fc1 and mlp.fc2 of DeiT-B's 12 blocks
# (ecoflap_tpu/models/eva_vit.py:44) and pwconv1 and pwconv2 of ConvNeXt-T's
# 18 blocks
CLS_TARGETS = {"deit": 12 * 4, "convnext": 2 * sum(CONVNEXT_DEPTHS)}
# the bf16 weights (DeiT-B 0.17 GB, ConvNeXt-T 0.06 GB), 128 calibration
# images and a stack's inputs, with a few GiB to spare
CLS_PEAK_GIB = 8.0
# ConvNeXt's layer scale is 1e-6 at the init, which leaves every block's
# output a rounding of its residual in bf16: the FB-named --ckpt draws it
# from U(0.5, 1.5) instead, so each block weighs in the scores and masks
CONVNEXT_GAMMA = (0.5, 1.5)
# DeiT's calibration CE is bf16, as the JAX head's (ROADMAP.md section 3),
# and the coarse stage takes the bf16 mean of a microbatch's losses: at the
# init (logits of order 0.5, a mean near ln 1000 with an ulp of 0.031) one
# perturbed linear moves it by less than an ulp, and nearly every MeZO score
# is 0. The timm-named --ckpt scales the head 16x, so the mean moves by some
# ulps (the scores are multiples of ulp / 2 eps). The random labels keep
# the mean above ln 1000 at any scale
DEIT_HEAD_SCALE = 16.0
# a coarse stage that scores: at least half the targets non-zero, in at
# least 4 distinct values (a stage that scores nothing, or one constant,
# fails)
HERE = os.path.dirname(os.path.abspath(__file__))
# phase 23 (c): LLaMA-7B's q_proj and down_proj (in, out), tokens, tp sizes
TP_SHAPES = {"q_proj": (4096, 4096), "down_proj": (11008, 4096)}
TP_TOKENS = 2048
TP_SIZES = (2, 4)
TP_ULP_FLOOR = 2.0 ** -6
TORCHRUN_TIMEOUT_S = 300
# phase 23 (b): the planted head's logit for an image's planted class, and
# the least margin over the others that its check accepts
PLANT_LOGIT = 10.0
PLANT_MARGIN = 5.0
TP_PATHS = {"q_proj": "model.layers.0.self_attn.q_proj",
            "down_proj": "model.layers.0.mlp.down_proj"}
CLS_MIN_NONZERO = 0.5
CLS_MIN_DISTINCT = 4
# phase 21, caption_coco_opt2.7b_eval.yaml's decode point through the
# evaluate CLI: 2 batches of 8, beam 5, the CLI's 10 new tokens and length
# penalty, min length 8 counting the prompt's 3 tokens ("a photo of")
OPT_EVAL_BATCHES = 2
OPT_POINT = dict(max_new_tokens=10, num_beams=5, min_length=8, length_penalty=-1.0)
OPT_PROMPT_TOKENS = 3
# BLIP-2 OPT-2.7B's bf16 weights are 7.7 GB; its caches at 40 rows are MBs
OPT_PEAK_GIB = 16.0
# phase 9's tiny BLIP-2 OPT generates (kernels 5x, the final LayerNorm's bias
# and the EOS row of the tied embedding along one random direction), as
# tests/test_torch_opt.py holds it against the JAX package
OPT_TINY_KERNEL_SCALE = 5.0
OPT_TINY_EOS_BOOST = 0.03


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def card_health() -> str:
    """The card's ECC error counts, clocks and temperature, as nvidia-smi
    reads them (for a report; fields the card lacks read "[N/A]")."""
    fields = ("ecc.errors.corrected.volatile.total,"
              "ecc.errors.uncorrected.volatile.total,clocks.sm,clocks.mem,"
              "temperature.gpu")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, check=False, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{fields} unread ({e})"
    return f"{fields} = {out.stdout.strip() or out.stderr.strip()}"


def philox_mismatch(P, torch, m, seed, dev, kw, rw):
    """What differs between the kernel's Philox words ``kw`` and the plain
    version's ``rw``: how many counters, the first one, and whether a second
    launch of each side gives its own first words again (a fault that does
    not repeat points at the card, one that does at the code)."""
    bad = torch.zeros(m, dtype=torch.bool, device=dev)
    for a, b in zip(kw, rw):
        bad |= a != b
    idx = bad.nonzero().flatten()
    j = idx[0].item()
    kw2 = P.philox_stream_cuda(m, seed, dev)
    rw2 = P.philox_stream_ref(m, seed, dev)
    k_same = all(torch.equal(a, b) for a, b in zip(kw, kw2))
    r_same = all(torch.equal(a, b) for a, b in zip(rw, rw2))
    k2_ref = all(torch.equal(a, b) for a, b in zip(kw2, rw))
    return (f"{idx.numel()} of {m} counters differ, the first {j} (kernel "
            f"{[w[j].item() for w in kw]}, plain {[w[j].item() for w in rw]}), "
            f"the last {idx[-1].item()}; a second launch: kernel repeats itself "
            f"{k_same}, plain repeats itself {r_same}, kernel equals plain "
            f"{k2_ref}; {card_health()}")


def ulp_distance(a, b):
    """|a - b| in float32 ulps of the larger magnitude."""
    import torch

    big = torch.maximum(a.abs(), b.abs())
    ulp = torch.nextafter(big, torch.full_like(big, math.inf)) - big
    return ((a - b).abs() / ulp).max().item()


def check_perturb(P, torch, shape, dtype):
    """Kernel vs plain on one shape and dtype; returns the worst |diff| of the
    perturbed weights at the main path's scale."""
    dev = torch.device("cuda")
    n = shape[0] * shape[1]
    seed = 0x9E3779B97F4A7C15 ^ (shape[0] << 20 | shape[1])
    m = -(-n // P.ELEMENTS_PER_COUNTER)  # the counters the n elements use
    kw = P.philox_stream_cuda(m, seed, dev)
    rw = P.philox_stream_ref(m, seed, dev)
    if not all(torch.equal(a, b) for a, b in zip(kw, rw)):
        raise AssertionError(f"{shape}: Philox words differ: "
                             + philox_mismatch(P, torch, m, seed, dev, kw, rw))
    del kw, rw

    zk = torch.zeros(shape, dtype=torch.float32, device=dev)
    zr = torch.zeros_like(zk)
    P.perturb_inplace(zk, seed, 1.0)
    P.perturb_inplace_ref(zr, seed, 1.0)
    ulps = ulp_distance(zk, zr)
    assert ulps <= Z_ULP_TOL, f"{shape}: z differs by {ulps} ulp"
    assert abs(zk.mean().item()) < 0.02 and abs(zk.std().item() - 1) < 0.02, shape
    share = (zk.abs() > 1).float().mean().item()
    assert 0.29 < share < 0.35, f"{shape}: P(|z|>1) = {share}"

    g = torch.Generator(device=dev).manual_seed(n)
    w0 = (torch.randn(shape, generator=g, device=dev) * 0.02).to(dtype)
    wk, wr = w0.clone(), w0.clone()
    P.perturb_inplace(wk, seed, 1e-3)
    P.perturb_inplace_ref(wr, seed, 1e-3)
    err = close_to_plain(torch, wk, wr, str(shape))

    plus = torch.zeros(shape, dtype=dtype, device=dev)
    minus = torch.zeros_like(plus)
    P.perturb_inplace(plus, seed, 1e-3)
    P.perturb_inplace(minus, seed, -1e-3)
    assert torch.equal(plus, -minus), f"{shape}: antithetic pair not exact"

    leaf = torch.ones((3, *shape), dtype=dtype, device=dev)
    for s in (1e-3, -2e-3, 1e-3):
        P.perturb_block_inplace(leaf, 1, seed, s)
    assert torch.equal(leaf[0], torch.ones_like(leaf[0])), "block 0 touched"
    assert torch.equal(leaf[2], torch.ones_like(leaf[2])), "block 2 touched"
    if dtype == torch.float32:
        restore = (leaf[1] - 1).abs().max().item()
        assert restore <= 1e-6, f"{shape}: f32 restore off by {restore}"
    torch.cuda.synchronize()
    return err, ulps


def close_to_plain(torch, got, want, what):
    """Kernel output against the plain version's: f32 within 1e-6; bf16 at
    most one ulp apart, on at most BF16_MISMATCH_SHARE of the elements."""
    err = (got.float() - want.float()).abs().max().item()
    if got.dtype == torch.bfloat16:
        bits = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
        assert bits.max().item() <= 1, f"{what}: bf16 outputs > 1 ulp apart"
        mism = (bits > 0).float().mean().item()
        assert mism <= BF16_MISMATCH_SHARE, f"{what}: {mism} of bf16 outputs differ"
    else:
        assert err <= 1e-6, f"{what}: f32 outputs differ by {err}"
    return err


def check_perturb_view(P, torch, dtype):
    """Both entries on leaf[1] of a ragged leaf, a view that starts off any
    16-byte boundary: against the plain version, bit for bit against the
    kernel on a contiguous copy (alignment never changes z), the other
    blocks untouched; returns the worst |kernel - plain|."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    leaf = (torch.randn(RAGGED_LEAF, generator=g, device=dev) * 0.02).to(dtype)
    keep = leaf.clone()
    view = leaf[1]
    assert view.data_ptr() % 16 != 0 and view.storage_offset() % 2 == 1
    seed = 0x2545F4914F6CDD1D
    want = P.perturb_ref(view, seed, 1e-3)
    copy = view.clone()
    out = P.perturb(view, seed, 1e-3)
    assert torch.equal(leaf, keep), f"perturb {dtype} view: the input was written"
    P.perturb_block_inplace(leaf, 1, seed, 1e-3)
    P.perturb_inplace(copy, seed, 1e-3)
    assert torch.equal(leaf[1], copy), f"{dtype} view: z depends on the start address"
    assert torch.equal(out, copy), f"perturb {dtype} view: differs from in place"
    assert torch.equal(leaf[0], keep[0]) and torch.equal(leaf[2], keep[2]), "blocks touched"
    err = close_to_plain(torch, leaf[1], want, f"{dtype} view")
    torch.cuda.synchronize()
    return err


def check_perturb_out_of_place(P, torch, shape, dtype):
    """``perturb`` vs its plain version, vs the in-place kernel (bit for bit)
    and its input left untouched; returns the worst |kernel - plain|."""
    dev = torch.device("cuda")
    seed = 0x5851F42D4C957F2D ^ (shape[0] << 20 | shape[1])
    g = torch.Generator(device=dev).manual_seed(shape[0] * shape[1] + 1)
    w = (torch.randn(shape, generator=g, device=dev) * 0.02).to(dtype)
    keep = w.clone()
    out = P.perturb(w, seed, 1e-3)
    assert torch.equal(w, keep), f"perturb {shape}: the input was written"
    inplace = w.clone()
    P.perturb_inplace(inplace, seed, 1e-3)
    assert torch.equal(out, inplace), f"perturb {shape}: differs from in place"
    ref = P.perturb_ref(w, seed, 1e-3)
    err = close_to_plain(torch, out, ref, f"perturb {shape}")
    torch.cuda.synchronize()
    return err


def qkv(torch, shape, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
                 for _ in range(3))


def check_flash(A, torch, shape):
    """The kernel against its plain version on q, k, v ~ N(0, 1) bf16, and
    on the strided (B, S, H, Dh) -> (B, H, S, Dh) views the model passes."""
    q, k, v = qkv(torch, shape, sum(shape))
    scale = shape[-1] ** -0.5
    out = A.flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    ref = A.flash_attention_ref(q, k, v, scale).float()
    assert torch.isfinite(out).all(), f"flash {shape}: non-finite output"
    diff = (out.float() - ref).abs()
    max_abs, mean_abs = diff.max().item(), diff.mean().item()
    rel = (diff / ref.abs().clamp_min(1.0)).max().item()
    del diff, ref
    assert rel <= FLASH_MAX_REL, f"flash {shape}: max rel err {rel}"
    assert mean_abs <= FLASH_MEAN_ABS, f"flash {shape}: mean abs err {mean_abs}"
    b, h, s, dh = shape
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    assert views[2].stride() == (s * h * dh, dh, h * dh, 1)
    assert torch.equal(A.flash_attention(*views, scale), out), \
        f"flash {shape}: strided inputs give other bits"
    out2, lse = A.flash_attention_lse(q, k, v, scale)
    assert torch.equal(out2, out), f"flash {shape}: the LSE output moved the output"
    lse_err = max((lse[i:i + 1] - A.flash_attention_lse_ref(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], scale)[1]).abs().max().item()
        for i in range(b))
    assert lse_err <= FLASH_LSE_MAX_ABS, f"flash {shape}: LSE off by {lse_err}"
    return max_abs, mean_abs, rel, lse_err


def check_flash_bwd(A, torch, shape):
    """The backward kernels against their plain version, one batch element
    at a time (the plain version holds float32 (H, S, S) tensors), on the
    kernel's own forward output and LSE; the strided (model-layout) inputs
    give the same bits, and so does a second call (no atomics)."""
    q, k, v = qkv(torch, shape, sum(shape) + 1)
    do = qkv(torch, shape, sum(shape) + 2)[0]
    scale = shape[-1] ** -0.5
    out, lse = A.flash_attention_lse(q, k, v, scale)
    grads = A.flash_attention_bwd(q, k, v, out, lse, do, scale)
    torch.cuda.synchronize()
    assert all(torch.isfinite(g).all() for g in grads), f"flash bwd {shape}: non-finite"
    again = A.flash_attention_bwd(q, k, v, out, lse, do, scale)
    assert all(torch.equal(a, b) for a, b in zip(grads, again)), \
        f"flash bwd {shape}: two calls differ"
    del again
    names = ("dq", "dk", "dv")
    diff2, ref2 = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0.0)
    max_abs, max_rel = 0.0, 0.0
    for i in range(shape[0]):
        sl = slice(i, i + 1)
        ref = A.flash_attention_bwd_ref(q[sl], k[sl], v[sl], out[sl], lse[sl], do[sl], scale)
        for n, g, r in zip(names, grads, ref):
            r = r.float()
            d = g[sl].float() - r
            diff2[n] += d.square().sum().item()
            ref2[n] += r.square().sum().item()
            max_abs = max(max_abs, d.abs().max().item())
            max_rel = max(max_rel, (d.abs() / r.abs().clamp_min(1.0)).max().item())
        del ref
    rel_l2 = {n: math.sqrt(diff2[n] / ref2[n]) for n in names}
    assert max_rel <= FLASH_BWD_MAX_REL, f"flash bwd {shape}: max rel err {max_rel}"
    assert max(rel_l2.values()) <= FLASH_BWD_REL_L2, f"flash bwd {shape}: {rel_l2}"
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v, out, do)]
    strided = A.flash_attention_bwd(*views[:4], lse, views[4], scale)
    assert all(torch.equal(a, b) for a, b in zip(strided, grads)), \
        f"flash bwd {shape}: strided inputs give other bits"
    torch.cuda.synchronize()
    return max_abs, max_rel, rel_l2


def check_flash_causal_and_refusals(A, torch):
    """Changing keys and values after row r leaves rows 0..r bit-identical;
    shapes, types and devices the kernel does not take raise."""
    shape, r = (2, 4, 512, 128), 300
    q, k, v = qkv(torch, shape, 11)
    out = A.flash_attention(q, k, v, 0.1)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, r + 1:] = k2[:, :, r + 1:] * 3 + 1
    v2[:, :, r + 1:] = -v2[:, :, r + 1:]
    out2 = A.flash_attention(q, k2, v2, 0.1)
    assert torch.equal(out[:, :, :r + 1], out2[:, :, :r + 1]), "flash is not causal"
    assert not torch.equal(out[:, :, r + 1:], out2[:, :, r + 1:])

    def refuses(exc, fn):
        try:
            fn()
        except exc:
            return
        raise AssertionError(f"expected {exc.__name__}")

    bad = torch.zeros(1, 2, 100, 128, dtype=torch.bfloat16, device="cuda")
    refuses(ValueError, lambda: A.mha(bad, bad, bad, causal=True, mode="flash"))
    refuses(ValueError, lambda: A.flash_attention(bad, bad, bad, 1.0))
    d64 = torch.zeros(1, 2, 512, 64, dtype=torch.bfloat16, device="cuda")
    refuses(ValueError, lambda: A.flash_attention(d64, d64, d64, 1.0))
    f32 = torch.zeros(1, 2, 512, 128, device="cuda")
    refuses(TypeError, lambda: A.flash_attention(f32, f32, f32, 1.0))
    lse32 = torch.zeros(1, 2, 512, device="cuda")
    refuses(TypeError, lambda: A.flash_attention_bwd(f32, f32, f32, f32, lse32, f32, 1.0))
    bad_lse = torch.zeros(1, 2, 100, device="cuda")
    refuses(ValueError, lambda: A.flash_attention_bwd(bad, bad, bad, bad, bad_lse, bad, 1.0))
    lse64 = torch.zeros(1, 2, 512, device="cuda")
    refuses(ValueError, lambda: A.flash_attention_bwd(d64, d64, d64, d64, lse64, d64, 1.0))
    torch.cuda.synchronize()


def check_flash_bwd_causal_and_grad(A, torch):
    """dO zero on query rows >= r: key rows >= r of dK and dV, and query
    rows >= r of dQ, are exactly 0. And an input that requires grad is
    served: ``flash_attention`` gives the no-grad output's bits, and its
    backward the kernels' dq, dk, dv."""
    shape, r = (2, 4, 512, 128), 300
    q, k, v = qkv(torch, shape, 12)
    do = qkv(torch, shape, 13)[0]
    do[:, :, r:] = 0
    out, lse = A.flash_attention_lse(q, k, v, 0.1)
    dq, dk, dv = A.flash_attention_bwd(q, k, v, out, lse, do, 0.1)
    for name, g in (("dq", dq), ("dk", dk), ("dv", dv)):
        assert torch.count_nonzero(g[:, :, r:]) == 0, f"flash bwd is not causal ({name})"
        assert torch.count_nonzero(g[:, :, :r]) > 0, name
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = A.flash_attention(*leaves, 0.1)
    assert got.requires_grad and torch.equal(got.detach(), out)
    grads = torch.autograd.grad(got, leaves, grad_outputs=do)
    assert all(torch.equal(a, b) for a, b in zip(grads, (dq, dk, dv))), \
        "the autograd Function's backward differs from the kernels'"
    torch.cuda.synchronize()


def time_cuda(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def c_launch(P, entry, *tensors, dev):
    """One launch of a perturbation C entry on bf16 ``tensors`` (seed 7,
    scale 1e-3), its ctypes arguments prepared once: the kernel's own time
    when timed back to back, since its host side (a few us) is shorter than
    the kernel. The wrapper's host side is timed apart."""
    import ctypes

    n = tensors[0].numel()
    args = (*(ctypes.c_void_p(t.data_ptr()) for t in tensors), 1, ctypes.c_uint64(n),
            ctypes.c_uint64(7), ctypes.c_float(1e-3), ctypes.c_void_p(P._stream(dev)))
    fn = getattr(P._lib(), entry)

    def launch():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{entry} launch failed: cudaError_t {rc}")
    return launch


def time_perturb(P, torch, shape):
    """The in-place kernel (by its C entry) and, for comparison, through its
    wrapper, whose host side bounds the rate of back-to-back launches at the
    smaller shapes."""
    dev = torch.device("cuda")
    n = shape[0] * shape[1]
    w = (torch.randn(shape, device=dev) * 0.02).to(torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(0)
    ms = time_cuda(torch, c_launch(P, "ecoflap_perturb_inplace", w, dev=dev), 50)
    wrapper = time_cuda(torch, lambda: P.perturb_inplace(w, 7, 1e-3), 50)
    plain = time_cuda(torch, lambda: P.perturb_inplace_ref(w, 7, 1e-3), 5)
    yard = time_cuda(torch, lambda: w.add_(torch.randn(
        shape, generator=g, device=dev, dtype=w.dtype).mul_(1e-3)), 20)
    bytes_ms = 2 * n * w.element_size() / HBM_BYTES_PER_S * 1e3
    ops_ms = PERTURB_OPS_PER_ELEMENT * n / F32_OPS_PER_S * 1e3
    return {"shape": list(shape), "ms": ms, "wrapper_ms": wrapper, "plain_ms": plain,
            "three_call_yardstick_ms": yard, "bytes_bound_ms": bytes_ms,
            "ops_bound_ms": ops_ms}


def time_perturb_host(P, torch, perturb_seed):
    """Host time of one in-place launch as the MeZO loop issues it, in
    microseconds: the median over 200 calls, each into an idle queue, of the
    seed (``perturb_seed``'s SeedSequence), the device guard with the stream
    lookup, the ctypes call alone (it launches the kernel), and the whole
    wrapper with its seed."""
    import statistics

    dev = torch.device("cuda")
    w = torch.zeros(XL_SHAPES[0], dtype=torch.bfloat16, device=dev)
    launch = c_launch(P, "ecoflap_perturb_inplace", w, dev=dev)

    def guard():
        with torch.cuda.device(dev):
            P._stream(dev)

    pieces = {"perturb_seed": lambda i: perturb_seed(SEED, i, 0, 0),
              "device_guard_and_stream": lambda i: guard(),
              "ctypes_launch": lambda i: launch(),
              "wrapper_with_seed": lambda i: P.perturb_inplace(
                  w, perturb_seed(SEED, i, 0, 0), 1e-3)}
    out = {}
    for name, fn in pieces.items():
        times = []
        for i in range(200):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(i)
            times.append(time.perf_counter() - t0)
        out[name] = statistics.median(times) * 1e6
    torch.cuda.synchronize()
    return out


def serial_cycle_paths():
    """{path: ((out, in) of each target, coarse microbatches)} of the paths
    that score by the serial in-place cycle: LLaMA-7B (phase 5), FlanT5-XL
    (phase 14), EVA-CLIP-g's visual tower (phase 16), CLIP ViT-B/16 (phase
    17), BLIP-1 (phase 18), DeiT-B (phase 19) and ConvNeXt-T (phase 20)."""
    t5_xl = xl_target_shapes()[4 * 39:]
    eva_g = [(4224, 1408), (1408, 1408), (6144, 1408), (1408, 6144)] * 40
    clip_b16 = CLIP_SHAPES[:4] * 12 + CLIP_SHAPES[4:] * 12
    return {"llama": (LLAMA_SHAPES * LLAMA_LAYERS, LLAMA_FIRST_STAGE // LLAMA_BATCH),
            "t5": (t5_xl, T5_FIRST_STAGE // BATCH_SIZE),
            "eva_clip": (eva_g, EVA_FIRST_STAGE // BATCH_SIZE),
            "clip": (clip_b16, CLIP_SAMPLES // CLIP_BATCH),
            "blip1": (BLIP1_SHAPES, BLIP1_SAMPLES // BLIP1_MICROBATCH),
            "deit": (CLIP_SHAPES[:4] * 12, CLS_FIRST_STAGE // CLS_BATCH),
            "convnext": (CONVNEXT_SHAPES, CLS_FIRST_STAGE // CLS_BATCH)}


def perturb_launch_weights(paths=None):
    """{kernel: {(out, in): launches}} on the zeroth-order paths: the lane
    ensemble of phase 4 launches the out-of-place kernel twice per target
    and coarse microbatch, each serial cycle (``serial_cycle_paths``, or the
    ones named in ``paths``) the in-place kernel three times."""
    inplace, out_of_place = {}, {}
    for s in xl_target_shapes():
        out_of_place[s] = out_of_place.get(s, 0) + 2 * (NUM_DATA_FIRST_STAGE // BATCH_SIZE)
    for name, (shapes, mb) in serial_cycle_paths().items():
        if paths is None or name in paths:
            for s in shapes:
                inplace[s] = inplace.get(s, 0) + 3 * mb
    return {"perturb_inplace": inplace, "perturb": out_of_place}


def weighted(timings, weights, key):
    """Launch-weighted mean of one timing field."""
    return sum(timings[s][key] * w for s, w in weights.items()) / sum(weights.values())


def time_perturb_out_of_place(P, torch, shape):
    dev = torch.device("cuda")
    n = shape[0] * shape[1]
    w = (torch.randn(shape, device=dev) * 0.02).to(torch.bfloat16)
    out = torch.empty_like(w)
    ms = time_cuda(torch, c_launch(P, "ecoflap_perturb", w, out, dev=dev), 50)
    wrapper = time_cuda(torch, lambda: P.perturb(w, 7, 1e-3), 50)
    plain = time_cuda(torch, lambda: P.perturb_ref(w, 7, 1e-3), 5)
    return {"shape": list(shape), "ms": ms, "wrapper_ms": wrapper, "plain_ms": plain,
            "bytes_bound_ms": 2 * n * w.element_size() / HBM_BYTES_PER_S * 1e3,
            "ops_bound_ms": PERTURB_OPS_PER_ELEMENT * n / F32_OPS_PER_S * 1e3}


def time_flash(A, torch, shape):
    """Kernel, library call and plain version at one shape, kernel and
    library in turns. The bound counts the causal half the function needs:
    Q Kᵀ and P V over S(S+1)/2 (query, key) pairs per head, 2 operations a
    multiply-add; bytes are q, k, v read once and o written once."""
    import torch.nn.functional as F

    b, h, s, dh = shape
    q, k, v = qkv(torch, shape, 5)
    scale = dh ** -0.5
    kernel = lambda: A.flash_attention(q, k, v, scale)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, scale=scale)
    k1 = time_cuda(torch, kernel, 20)
    l1 = time_cuda(torch, library, 20)
    l2 = time_cuda(torch, library, 20)
    k2 = time_cuda(torch, kernel, 20)
    plain = time_cuda(torch, lambda: A.flash_attention_ref(q, k, v, scale), 3)
    ops = 2 * 2 * b * h * dh * s * (s + 1) / 2
    nbytes = 4 * b * h * s * dh * q.element_size()
    return {"shape": list(shape), "ms": (k1 + k2) / 2, "library_ms": (l1 + l2) / 2,
            "plain_ms": plain, "ops_bound_ms": ops / BF16_OPS_PER_S * 1e3,
            "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def time_flash_bwd(A, torch, shape):
    """The backward (Di, dK/dV and dQ: one ``flash_attention_bwd`` call)
    against the library's backward, ``scaled_dot_product_attention``'s
    forward plus backward less its forward (both with grad), in turns, and
    the plain version. The bound counts five products over the causal half
    (S, dP, dV, dK, dQ), 2.5x the forward's operations; bytes are q, k, v,
    o, dO and the float32 LSE read once and dq, dk, dv written once."""
    import torch.nn.functional as F

    b, h, s, dh = shape
    q, k, v = qkv(torch, shape, 5)
    do = qkv(torch, shape, 6)[0]
    scale = dh ** -0.5
    out, lse = A.flash_attention_lse(q, k, v, scale)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    kernel = lambda: A.flash_attention_bwd(q, k, v, out, lse, do, scale)  # noqa: E731

    def lib_fwd():
        return F.scaled_dot_product_attention(*leaves, is_causal=True, scale=scale)

    def lib_fwd_bwd():
        torch.autograd.grad(lib_fwd(), leaves, grad_outputs=do)

    k1 = time_cuda(torch, kernel, 20)
    f1, l1 = time_cuda(torch, lib_fwd, 20), time_cuda(torch, lib_fwd_bwd, 20)
    l2, f2 = time_cuda(torch, lib_fwd_bwd, 20), time_cuda(torch, lib_fwd, 20)
    k2 = time_cuda(torch, kernel, 20)
    plain = time_cuda(torch, lambda: A.flash_attention_bwd_ref(
        q, k, v, out, lse, do, scale), 2)
    ops = 5 * 2 * b * h * dh * s * (s + 1) / 2
    nbytes = 8 * b * h * s * dh * q.element_size() + b * h * s * lse.element_size()
    return {"shape": list(shape), "ms": (k1 + k2) / 2,
            "library_ms": (l1 + l2 - f1 - f2) / 2, "library_fwd_bwd_ms": (l1 + l2) / 2,
            "plain_ms": plain, "ops_bound_ms": ops / BF16_OPS_PER_S * 1e3,
            "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


# the SparseGPT sweep kernel against _sweep_block (phase 2): (label, K, rows,
# weight columns, block [i1, i2), prune_n, prune_m, dtype, kind); kind
# "nan_lane": lane 0's Hinv is NaN, as a failed Hessian leaves it; "ties":
# weights on a 0.5 grid under Hinv = I / 2, so n:m saliences tie
SWEEP_CASES = [
    ("ViT-g qkv rows", 1, 4224, 384, 128, 256, 0, 0, "float32", "random"),
    ("ViT-g proj and fc2 rows", 1, 1408, 384, 128, 256, 0, 0, "float32", "random"),
    ("ViT-g fc1 rows", 1, 6144, 384, 128, 256, 0, 0, "float32", "random"),
    ("T5 q/k/v/o group", 4, 2048, 384, 128, 256, 0, 0, "float32", "random"),
    ("T5 wi_0/wi_1 group", 2, 5120, 384, 128, 256, 0, 0, "float32", "random"),
    ("2:4, two lanes", 2, 1408, 384, 128, 256, 2, 4, "float32", "random"),
    ("2:4 at the T5 width", 1, 5120, 384, 0, 128, 2, 4, "float32", "random"),
    ("ragged last block, B = 44", 2, 1408, 300, 256, 300, 0, 0, "float32", "random"),
    ("ragged last block, B = 44, 2:4", 2, 1408, 300, 256, 300, 2, 4, "float32", "random"),
    ("a NaN lane beside a finite one", 2, 1408, 384, 128, 256, 0, 0, "float32", "nan_lane"),
    ("a NaN lane beside a finite one, 2:4", 2, 1408, 384, 128, 256, 2, 4, "float32",
     "nan_lane"),
    ("tied saliences, 2:4", 1, 512, 256, 0, 128, 2, 4, "float32", "ties"),
    ("tied saliences, 16:32", 1, 512, 256, 0, 128, 16, 32, "float32", "ties"),
    ("float64, two lanes", 2, 1408, 384, 128, 256, 0, 0, "float64", "random"),
    ("float64, 2:4", 2, 1408, 384, 128, 256, 2, 4, "float64", "random"),
]
SWEEP_TIMING_ROWS = (1408, 4224, 6144)  # ViT-g's four linears' out widths


def sweep_inputs(torch, k, rows, cols, i1, i2, prune_n, dtype, kind, seed):
    """(w, hinv1, mask1) of one column block as the pruning path makes them:
    Hinv from ``prepare_hinv`` of a random Gram matrix, the 50% per-block
    mask from the saliency (None with n:m)."""
    from ecoflap_tpu_torch.pruning import sparsegpt as sg

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(k, rows, cols, generator=g, device="cuda", dtype=dt)
    if kind == "ties":
        w = (w * 2).round() / 2
        hinv = 0.5 * torch.eye(cols, device="cuda", dtype=dt).expand(k, cols, cols)
    else:
        x = torch.randn(k, 2 * cols, cols, generator=g, device="cuda", dtype=dt)
        hinv = sg.prepare_hinv((1.0 / cols) * x.mT @ x)[0]
    hinv = hinv.contiguous()
    if kind == "nan_lane":
        hinv[0] = float("nan")
    hinv1 = hinv[:, i1:i2, i1:i2]
    mask1 = None
    if prune_n == 0:
        w1 = w[..., i1:i2]
        sal = w1 ** 2 / torch.diagonal(hinv1, dim1=-2, dim2=-1)[:, None, :] ** 2
        mask1 = torch.stack([sg._mask_per_tensor(sal[j], 0.5) for j in range(k)])
    return w, hinv1, mask1


def unlike_bits(torch, a, b):
    """Entries of a and b whose bits differ, NaN counting as equal to NaN."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    return ~((a.view(ints) == b.view(ints)) | (a.isnan() & b.isnan()))


def check_sparsegpt_sweep(S, torch):
    """Each SWEEP_CASES block swept by the kernel (on a copy of the weight,
    in place) and by ``_sweep_block`` on the card. Returns {label: (Q1
    entries unlike, Err1 entries unlike, largest |difference| among them,
    the columns outside the block untouched, a second launch the same)};
    the caller logs them all, then gates on zero."""
    from ecoflap_tpu_torch.pruning import sparsegpt as sg

    out = {}
    for seed, (label, k, rows, cols, i1, i2, n, m, dtype, kind) in enumerate(SWEEP_CASES):
        w, hinv1, mask1 = sweep_inputs(torch, k, rows, cols, i1, i2, n, dtype, kind, seed)
        plain_mask = (mask1.clone() if mask1 is not None
                      else torch.zeros(k, rows, i2 - i1, dtype=torch.bool, device="cuda"))
        q, e = sg._sweep_block(w[..., i1:i2].clone(), hinv1, plain_mask, n, m)
        got, again = w.clone(), w.clone()
        err = S.sparsegpt_sweep(got[..., i1:i2], hinv1, mask1, n, m)
        err2 = S.sparsegpt_sweep(again[..., i1:i2], hinv1, mask1, n, m)
        torch.cuda.synchronize()
        bad_q, bad_e = unlike_bits(torch, got[..., i1:i2], q), unlike_bits(torch, err, e)
        diffs = [(a - b)[bad].abs().max().item() for a, b, bad in
                 ((got[..., i1:i2], q, bad_q), (err, e, bad_e)) if bad.any()]
        outside = (torch.equal(got[..., :i1], w[..., :i1])
                   and torch.equal(got[..., i2:], w[..., i2:]))
        repeat = not (unlike_bits(torch, got, again).any()
                      or unlike_bits(torch, err, err2).any())
        out[label] = (int(bad_q.sum()), int(bad_e.sum()), max(diffs, default=0.0),
                      outside, repeat)
    return out


def time_sparsegpt_sweep(S, torch, rows, bsz=128):
    """One 128-column block of a (rows, 1408) float32 weight with its 50%
    mask (K = 1, ViT-g's width): the kernel by its C entry, its arguments
    prepared once, and through the wrapper (with Err1's allocation), then
    the plain ``_sweep_block``. Repeated launches sweep the block's Q1
    again, which takes the same time. The bound counts W read, Q1 and Err1
    written (4 bytes each), the mask (1 byte) and Hinv1's upper triangle
    once; the operations, 2 a multiply-add and 1 a division."""
    import ctypes

    from ecoflap_tpu_torch.pruning import sparsegpt as sg

    w, hinv1, mask1 = sweep_inputs(torch, 1, rows, 1408, 0, bsz, 0, "float32", "random", 11)
    w1 = w[..., :bsz]
    plain = time_cuda(torch, lambda: sg._sweep_block(w1.clone(), hinv1, mask1.clone(), 0, 0),
                      5)
    err = torch.empty(1, rows, bsz, device="cuda")
    args = (ctypes.c_void_p(w1.data_ptr()), 0, 1, rows, bsz, w1.stride(0), w1.stride(1),
            ctypes.c_void_p(hinv1.data_ptr()), hinv1.stride(0), hinv1.stride(1),
            ctypes.c_void_p(mask1.data_ptr()), ctypes.c_void_p(err.data_ptr()), 0, 0,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    entry = S._lib().ecoflap_sparsegpt_sweep

    def launch():
        rc = entry(*args)
        if rc != 0:
            raise RuntimeError(f"ecoflap_sparsegpt_sweep launch failed: cudaError_t {rc}")

    k1 = time_cuda(torch, launch, 200)
    wrapper = time_cuda(torch, lambda: S.sparsegpt_sweep(w1, hinv1, mask1), 200)
    k2 = time_cuda(torch, launch, 200)
    nbytes = rows * bsz * (4 + 4 + 4 + 1) + 4 * bsz * (bsz + 1) // 2
    ops = rows * (bsz * (bsz - 1) + bsz)
    return {"shape": [rows, bsz], "ms": (k1 + k2) / 2, "wrapper_ms": wrapper,
            "plain_ms": plain, "ops_bound_ms": ops / F32_OPS_PER_S * 1e3,
            "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def bound(t):
    by = "bytes" if t["bytes_bound_ms"] >= t["ops_bound_ms"] else "operations"
    return max(t["bytes_bound_ms"], t["ops_bound_ms"]), by


def ptxas_usage(log):
    """{kernel: {"registers", "stack_frame", "spill_stores", "spill_loads",
    "instances"}} from one library's ``nvcc -Xptxas -v`` output, the largest
    over a template kernel's instances (the register count is the launch's;
    a warp-specialised kernel's warpgroups then move registers between them
    with setmaxnreg)."""
    usage, kernel = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:  # a mangled name follows
            found = re.search(r"\d([a-z][a-z_]*_kernel)", line)
            kernel = found.group(1) if found else None
            if kernel:
                u = usage.setdefault(kernel, {"instances": 0})
                u["instances"] += 1
            continue
        fields = ()
        if kernel and "spill stores" in line:
            found = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                              r"(\d+) bytes spill loads", line)
            fields = zip(("stack_frame", "spill_stores", "spill_loads"), found.groups())
        elif kernel and "Used" in line and "registers" in line:
            fields = [("registers", re.search(r"Used (\d+) registers", line).group(1))]
        for key, val in fields:
            usage[kernel][key] = max(usage[kernel].get(key, 0), int(val))
    return usage


def xl_target_shapes():
    """(out, in) of every main-path target, in the adapter's order."""
    vit = [(4224, 1408), (1408, 1408), (6144, 1408), (1408, 6144)] * 39
    enc = [(2048, 2048)] * 4 + [(5120, 2048)] * 2 + [(2048, 5120)]
    dec = [(2048, 2048)] * 8 + [(5120, 2048)] * 2 + [(2048, 5120)]
    return vit + enc * 24 + dec * 24


def small_reference_check(torch):
    """The port on the card against the port on the CPU, tiny BLIP-2 in f32:
    per-sample losses and MeZO scores (kernel noise vs its plain version)."""
    from ecoflap_tpu_torch.data import calibration as cal
    from ecoflap_tpu_torch.models import blip2
    from ecoflap_tpu_torch.pruning.mezo import mezo_leaf_scores

    cfg = blip2.tiny_config()
    spec = cal.CalibrationSpec(8, 4)
    batch = cal.build_vl_calibration_batch(
        cal.synthetic_vl_samples(8, cfg.vit.img_size, 0),
        cal.HashTokenizer(vocab_size=cfg.t5.vocab_size), spec, 0)
    # one set of weights for both: the CPU and CUDA generators draw
    # different numbers from one seed
    cpu_model = blip2.build_model(cfg, device="cpu", dtype=torch.float32, seed=3)
    out = {}
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(cpu_model).to(dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        ad = blip2.make_adapter(model)
        with torch.no_grad():
            loss = model.per_sample_loss(b).cpu()
        scores = mezo_leaf_scores(ad.loss_fn, model, b, 2, ad.targets(), eps=0.05,
                                  seed=5, loss_plans=ad.build_mezo_plans(model, b))
        out[dev] = (loss, scores)
    (lg, sg), (lc, sc) = out["cuda"], out["cpu"]
    assert torch.isfinite(lg).all() and lg.shape == (8,)
    lerr = ((lg - lc).abs() / lc.abs()).max().item()
    assert lerr < 1e-4, f"tiny per-sample loss card vs CPU: rel {lerr}"
    # a score is |L+ - L-| / 2eps summed over 2 microbatches: float32 losses
    # (~4) that differ by ~1e-6 between the two devices give ~4e-5 absolute
    serr = max(abs(sg[k] - sc[k]) - 1e-3 * abs(sc[k]) for k in sc)
    assert serr <= 2e-4, f"tiny MeZO scores card vs CPU: {serr} beyond rtol 1e-3"
    return lerr, serr


def small_llama_config(llama):
    """The small LLaMA of phase 9's card-vs-CPU checks: 2 layers, d_model
    256, 2 heads of 128 (flash-eligible), S 512, vocab 512."""
    return llama.LlamaConfig(vocab_size=512, d_model=256, num_layers=2, num_heads=2,
                             num_kv_heads=2, d_ff=688, max_seq_len=512)


def small_llama_check(torch):
    """A small LLaMA (2 layers, d_model 256, 2 heads of 128, S 512, vocab
    512): bf16 on the card, where attention is the flash kernel, against
    f32 on the CPU, where it is the plain path; one set of weights, made on
    the CPU. Returns the relative L2 error of the logits and the worst
    relative per-sample loss difference."""
    from ecoflap_tpu_torch.data import calibration as cal
    from ecoflap_tpu_torch.models import llama
    from ecoflap_tpu_torch.ops import attention as A

    cfg = small_llama_config(llama)
    cpu_model = llama.build_model(cfg, device="cpu", dtype=torch.float32, seed=3)
    ids = cal.build_lm_calibration_batch(
        cal.synthetic_token_stream(4, 512, cfg.vocab_size, 0), 4, 512, 0)["input_ids"]
    with torch.no_grad():
        want = cpu_model(ids)
        card = copy.deepcopy(cpu_model).to("cuda", torch.bfloat16)
        before = A.flash_attention.launches
        got = card(ids.cuda()).cpu()
    assert A.flash_attention.launches - before == cfg.num_layers, \
        "the small LLaMA did not run the flash kernel"
    assert torch.isfinite(got).all() and got.shape == (4, 512, cfg.vocab_size)
    logits_rel = ((got - want).norm() / want.norm()).item()
    assert logits_rel < LLAMA_LOGITS_REL, \
        f"small LLaMA logits card (bf16) vs CPU (f32): relative L2 {logits_rel}"
    lg, lc = (llama.next_token_ce(x, ids, None) for x in (got, want))
    loss_rel = ((lg - lc).abs() / lc.abs()).max().item()
    assert loss_rel < LLAMA_LOSS_RTOL, \
        f"small LLaMA loss card (bf16) vs CPU (f32): rel {loss_rel}"
    grad_rel = small_llama_grad_sums(torch, llama, A, cfg, cpu_model, ids)
    return logits_rel, loss_rel, grad_rel


def small_llama_grad_sums(torch, llama, A, cfg, cpu_model, ids):
    """GradOnly first-order sums of the small LLaMA, 2 microbatches through
    the streamed per-block backward: bf16 on the card (flash forward and
    backward kernels, the card's lm_head product) against f32 on the CPU,
    and a second card run that must give the same bits. Returns the worst
    relative difference over the 14 targets."""
    from ecoflap_tpu_torch.pruning.first_order import first_order_group_sums

    sums = {}
    for dev, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        model = copy.deepcopy(cpu_model).to(dev, dtype)
        batch = {"input_ids": ids.to(dev)}
        ad = llama.make_adapter(model)
        before = A.flash_attention_bwd.launches
        sums[dev] = first_order_group_sums(ad.loss_fn, model, batch, 2, ad.targets(),
                                           "GradOnly", plans=ad.build_mezo_plans(model, batch))
        if dev == "cuda":
            assert A.flash_attention_bwd.launches - before == 2 * cfg.num_layers, \
                "the small LLaMA's backward did not run the flash backward kernels"
            # the sums feed the allocator: a second run must give the same dict
            again = first_order_group_sums(ad.loss_fn, model, batch, 2, ad.targets(),
                                           "GradOnly",
                                           plans=ad.build_mezo_plans(model, batch))
            assert again == sums[dev], "two first-order runs on the card differ"
    card, cpu = sums["cuda"], sums["cpu"]
    assert len(card) == 7 * cfg.num_layers
    assert all(math.isfinite(v) and v > 0 for v in card.values())
    grad_rel = max(abs(card[k] - cpu[k]) / cpu[k] for k in cpu)
    assert grad_rel < LLAMA_GRAD_SUMS_RTOL, \
        f"small LLaMA GradOnly sums card (bf16) vs CPU (f32): rel {grad_rel}"
    return grad_rel


def small_blip2_setup(torch):
    """A small BLIP-2 (ViT-B/16 + flan-t5-base, random float32 weights, seed
    3) on the card with 8 synthetic samples in 2 microbatches, and the
    targets of the first and last block of each stack (44)."""
    from ecoflap_tpu_torch.data import calibration as cal
    from ecoflap_tpu_torch.models import blip2

    cfg = blip2.blip2_small()
    model = blip2.build_model(cfg, device="cuda", dtype=torch.float32, seed=3)
    batch = cal.build_vl_calibration_batch(
        cal.synthetic_vl_samples(8, cfg.vit.img_size, 0),
        cal.HashTokenizer(vocab_size=cfg.t5.vocab_size), cal.CalibrationSpec(8, 4), 0)
    batch = {k: v.cuda() for k, v in batch.items()}
    ad = blip2.make_adapter(model)
    targets = [t for t in ad.targets() if t.block_index in (0, t.stack.num_blocks - 1)]
    return ad, batch, targets


def ensemble_gap(P, ad, batch, targets):
    """Scores of ``targets`` by the lane ensemble and by the serial cycle
    with one seed, so one z per (target, microbatch); each path's kernel
    launches checked. Returns the worst difference beyond rtol."""
    from ecoflap_tpu_torch.pruning.mezo import mezo_leaf_scores

    scores = {}
    for ens in (True, False):
        before = P.perturb.launches, P.perturb_inplace.launches
        scores[ens] = mezo_leaf_scores(
            ad.loss_fn, ad.model, batch, 2, targets, eps=ENSEMBLE_EPS, seed=5,
            loss_plans=ad.build_mezo_plans(ad.model, batch), ensemble=ens)
        made = P.perturb.launches - before[0], P.perturb_inplace.launches - before[1]
        assert made == ((2 * 2 * len(targets), 0) if ens else (0, 3 * 2 * len(targets))), made
    ens, ser = scores[True], scores[False]
    assert all(math.isfinite(v) and v >= 0 for v in ens.values())
    err = max(abs(ens[k] - ser[k]) - ENSEMBLE_RTOL * abs(ser[k]) for k in ser)
    assert err <= ENSEMBLE_ATOL, f"lane ensemble vs serial: {err} beyond rtol {ENSEMBLE_RTOL}"
    return err


def ensemble_vs_serial_checks(torch, P, small_blip2):
    """The lane ensemble against the serial cycle on the card in float32:
    the small BLIP-2's 44 targets, and every target of the small LLaMA of
    ``small_llama_check`` (finished lane by lane)."""
    from ecoflap_tpu_torch.data import calibration as cal
    from ecoflap_tpu_torch.models import llama

    ad, batch, targets = small_blip2
    out = {"small BLIP-2": (ensemble_gap(P, ad, batch, targets), len(targets))}
    cfg = small_llama_config(llama)
    model = llama.build_model(cfg, device="cuda", dtype=torch.float32, seed=3)
    ids = cal.build_lm_calibration_batch(
        cal.synthetic_token_stream(4, 512, cfg.vocab_size, 0), 4, 512, 0)["input_ids"]
    lad = llama.make_adapter(model)
    out["small LLaMA"] = (ensemble_gap(P, lad, {"input_ids": ids.cuda()},
                                       lad.targets()), len(lad.targets()))
    return out


def shared_mode_check(P, small_blip2):
    """``noise_mode="shared"`` by the lane ensemble on the small BLIP-2: one
    z per target for both microbatches, so one +eps and one -eps launch per
    target; finite, non-negative, distinct scores."""
    from ecoflap_tpu_torch.pruning.mezo import mezo_leaf_scores

    ad, batch, targets = small_blip2
    before = P.perturb.launches
    scores = mezo_leaf_scores(ad.loss_fn, ad.model, batch, 2, targets,
                              eps=ENSEMBLE_EPS, seed=5, noise_mode="shared",
                              loss_plans=ad.build_mezo_plans(ad.model, batch))
    assert P.perturb.launches - before == 2 * len(targets)
    vals = list(scores.values())
    assert all(math.isfinite(v) and v >= 0 for v in vals), "shared-mode scores"
    assert len(set(vals)) == len(vals), "shared-mode scores not distinct"
    return min(vals), max(vals), len(vals)


def small_sparsegpt_check(torch, hessian_bf16=False):
    """Tiny BLIP-2 SparseGPT from one random dict on the card and on the
    CPU, float32 (with ``hessian_bf16``, from Gram sums rounded once to
    bf16 on both sides, under the SPARSEGPT_BF16_* gates, and returning
    the first block's relative L2 too). The tiny init leaves the ViT's Hessians singular (zero
    LayerNorm biases, uniform attention), where any two libraries' float32
    Cholesky factors differ by O(1); its LayerNorm biases, v bias and qkv
    weights are drawn wider, as tests/test_torch_sparsegpt_pipeline.py does,
    and the labels carry 16 tokens. Returns (mask mismatch share, relative
    L2 of the pruned weights)."""
    from ecoflap_tpu_torch.models import blip2, eva_vit
    from ecoflap_tpu_torch.pruning.loader import load_pruner

    cfg = blip2.tiny_config()
    cpu_model = blip2.build_model(cfg, device="cpu", dtype=torch.float32, seed=3)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for blk in cpu_model.visual_encoder.blocks:
            for t, std in ((blk.norm1.bias, 0.5), (blk.norm2.bias, 0.5),
                           (blk.attn.qkv.weight, 0.35), (blk.attn.v_bias, 0.5)):
                t.copy_(torch.randn(t.shape, generator=g) * std)
    n, img, vocab = 8, cfg.vit.img_size, cfg.t5.vocab_size
    batch = {"image": torch.randn(n, img, img, 3, generator=g),
             "text_input_ids": torch.randint(2, vocab, (n, 6), generator=g),
             "text_input_mask": torch.ones(n, 6, dtype=torch.long),
             "labels": torch.randint(2, vocab, (n, 16), generator=g)}
    names = [t.name for t in blip2.make_adapter(cpu_model).targets()]
    picks = torch.randint(0, 3, (len(names),), generator=g).tolist()
    sd = {k: (0.3, 0.5, 0.6)[i] for k, i in zip(names, picks)}
    specs = {"visual_encoder.blocks": f"{cfg.vit.depth}-0.5-1.0-1.0",
             "t5_model.encoder.block": f"{cfg.t5.num_layers}-0.5-1.0-1.0",
             "t5_model.decoder.block": f"{cfg.t5.num_decoder_layers}-0.5-1.0-1.0"}
    pruned = {}
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(cpu_model).to(dev)
        ad = blip2.make_adapter(model)
        load_pruner("blipt5_sparsegpt_pruner", ad, {k: v.to(dev) for k, v in batch.items()},
                    2, dict(stack_specs=specs, sparsity_dict=sd, hessian_bf16=hessian_bf16,
                            verbose=False)).prune()
        pruned[dev] = [t.weight(model).detach().cpu().reshape(-1) for t in ad.targets()]
    # the first block's linears (ViT block 0) see the same inputs on both sides
    first = len(eva_vit.LINEAR_NAMES)
    card0, cpu0 = (torch.cat(pruned[dev][:first]) for dev in ("cuda", "cpu"))
    card, cpu = (torch.cat(pruned[dev]) for dev in ("cuda", "cpu"))
    assert torch.isfinite(card).all(), "tiny SparseGPT on the card: non-finite weights"
    mask_share = ((card == 0) != (cpu == 0)).float().mean().item()
    rel_l2 = ((card - cpu).norm() / cpu.norm()).item()
    if not hessian_bf16:
        assert mask_share <= SPARSEGPT_MASK_SHARE, f"SparseGPT masks card vs CPU: {mask_share}"
        assert rel_l2 <= SPARSEGPT_REL_L2, f"SparseGPT weights card vs CPU: {rel_l2}"
        return mask_share, rel_l2
    rel_l2_first = ((card0 - cpu0).norm() / cpu0.norm()).item()
    assert torch.equal(card0 == 0, cpu0 == 0), "SparseGPT bf16 H: block 0 masks differ"
    assert rel_l2_first <= SPARSEGPT_BF16_FIRST_REL_L2, \
        f"SparseGPT bf16 H: block 0 weights card vs CPU {rel_l2_first}"
    assert mask_share <= SPARSEGPT_BF16_MASK_SHARE, f"SparseGPT bf16 H masks: {mask_share}"
    return mask_share, rel_l2, rel_l2_first


def vit_block_sparsegpt(torch, ratio):
    """Phase 8's regime at full width: ViT-g block 0 as phase 8 builds it
    (the CLI's seed, bf16 weights, its 128 calibration images in
    microbatches of 8), its four Hessians collected on the card, and each
    linear pruned by SparseGPT from the same float32 H and W on the card
    and on the CPU. Per linear: the Hessian's smallest and largest
    eigenvalue (float64, on the card), whether the undamped float32
    Cholesky fails on each side, the mask mismatch share, the pruned
    weights' relative L2, and on each side the relative reconstruction
    error tr(D H D^T) / tr(W H W^T), D = W - W_pruned: the objective the
    sweep minimises, which H's near-null directions barely move, beside
    that of the card's mask applied without the sweep's updates. Gates:
    the two sides' objectives within SPARSEGPT_XL_RECON_RTOL, and the sweep
    below the mask alone on both."""
    from ecoflap_tpu_torch.data import calibration as cal
    from ecoflap_tpu_torch.models import blip2, eva_vit

    cfg = blip2.blip2_flant5xl()
    with torch.device("meta"):
        vit = eva_vit.EvaViT(cfg.vit).to(torch.bfloat16)
    vit = vit.to_empty(device="cuda").requires_grad_(False)
    # Blip2T5.init_ draws the visual encoder first from the CLI's generator
    vit.init_(torch.Generator(device="cuda").manual_seed(SEED))
    spec = cal.CalibrationSpec(NUM_SAMPLES, BATCH_SIZE)
    batch = cal.build_vl_calibration_batch(
        cal.synthetic_vl_samples(NUM_SAMPLES, cfg.vit.img_size, SEED),
        cal.HashTokenizer(vocab_size=cfg.t5.vocab_size), spec, SEED)
    images = batch["image"].cuda()
    block = vit.blocks[0]
    stats = {}
    with torch.no_grad():
        for c in range(0, NUM_SAMPLES, BATCH_SIZE):
            _, part = block(vit.embed(images[c:c + BATCH_SIZE]), None, collect="hessian")
            stats = {k: stats[k] + v if k in stats else v for k, v in part.items()}
    out = {local: sparsegpt_card_vs_cpu(
        torch, block.get_submodule(local).weight.to(torch.float32),
        (2.0 / NUM_SAMPLES) * stats[local].to(torch.float32), ratio, local)
        for local in eva_vit.LINEAR_NAMES}
    del vit, stats
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def plain_sweep_on_card(torch, sg):
    """The pruning code's in-block sweep on the card by ``_sweep_block``,
    the kernel's plain version, in place of the kernel."""
    def plain(w1, hinv1, mask1, prune_n, prune_m):
        if mask1 is None:
            mask1 = torch.zeros(w1.shape, dtype=torch.bool, device=w1.device)
        q1, err1 = sg._sweep_block(w1.clone(), hinv1, mask1, prune_n, prune_m)
        w1.copy_(q1)
        return err1

    kernel, sg.sparsegpt_sweep = sg.sparsegpt_sweep, plain
    try:
        yield
    finally:
        sg.sparsegpt_sweep = kernel


def sparsegpt_card_vs_cpu(torch, w, h, ratio, name):
    """One weight ``w`` pruned by SparseGPT from one float32 Hessian ``h``
    (both on the card) on the card and on the CPU (vit_block_sparsegpt's
    readings and gates); on the card, the prune through the sweep kernel
    (one launch a column block, counted) against the prune through
    ``_sweep_block``, alone and in a group of two lanes, bit for bit."""
    from ecoflap_tpu_torch.ops import sparsegpt_sweep as S
    from ecoflap_tpu_torch.pruning import sparsegpt as sg

    ev = torch.linalg.eigvalsh(h.double())
    sym = (h + h.mT) / 2
    fails = tuple(int(torch.linalg.cholesky_ex(m).info) != 0 for m in (sym, sym.cpu()))

    def both_sweeps():
        return (sg.sparsegpt_prune_weight(w, h, ratio),
                sg.sparsegpt_prune_weight_group(torch.stack([w, w]), torch.stack([h, h]),
                                                [ratio, ratio]))

    launches = S.sparsegpt_sweep.launches
    card, group = both_sweeps()
    launches = S.sparsegpt_sweep.launches - launches
    assert launches == 2 * -(-w.shape[1] // 128), (name, launches)
    with plain_sweep_on_card(torch, sg):
        plain, plain_group = both_sweeps()
    assert torch.equal(card, plain) and torch.equal(group, plain_group), \
        f"{name}: the prune through the sweep kernel is not the plain one bit for bit"
    cpu = sg.sparsegpt_prune_weight(w.cpu(), h.cpu(), ratio).cuda()
    assert torch.isfinite(card).all() and torch.isfinite(cpu).all(), name
    hd, wd = h.double(), w.double()

    def recon(p):
        d = wd - p.double()
        return ((d @ hd) * d).sum().item() / ((wd @ hd) * wd).sum().item()

    r = {"eig_ratio": (ev[0] / ev[-1]).item(), "undamped_cholesky_fails": fails,
         "rank": int((ev > ev[-1] * 1e-6).sum()), "size": h.shape[0],
         "mask_share": ((card == 0) != (cpu == 0)).float().mean().item(),
         "rel_l2": ((card - cpu).norm() / cpu.norm()).item(),
         "recon_card": recon(card), "recon_cpu": recon(cpu),
         "recon_mask_only": recon(w * (card != 0)), "kernel_launches": launches}
    assert abs(r["recon_card"] / r["recon_cpu"] - 1) <= SPARSEGPT_XL_RECON_RTOL, (name, r)
    assert max(r["recon_card"], r["recon_cpu"]) < r["recon_mask_only"], (name, r)
    return r


def check_sparsegpt_prune(torch, res, sd):
    """Phase 8's gates on the pruned BLIP-2: every prunable weight finite,
    each block's zero share (over its linears, which share its ratio) within
    SPARSEGPT_BLOCK_TOL of that ratio, global sparsity 0.5 +- 0.01. Returns
    the worst block gap."""
    from ecoflap_tpu_torch.models import blip2

    ad = blip2.make_adapter(res["model"])
    worst = 0.0
    for stack in ad.stacks:
        for i, block in enumerate(stack.blocks(ad.model)):
            zeros = total = 0
            ratios = {sd[stack.weight_key(i, ln)] for ln in stack.linear_names}
            assert len(ratios) == 1, ratios
            for local in stack.linear_names:
                w = block.get_submodule(local).weight
                assert torch.isfinite(w).all(), f"{stack.weight_key(i, local)}: non-finite"
                zeros += int((w == 0).sum())
                total += w.numel()
            gap = abs(zeros / total - ratios.pop())
            assert gap <= SPARSEGPT_BLOCK_TOL, f"{stack.name}.{i}: zero share off by {gap}"
            worst = max(worst, gap)
    assert abs(res["prunable_sparsity"] - 0.5) <= 0.01, res["prunable_sparsity"]
    return worst


def sweep_blocks(model):
    """{stack: column blocks of 128 over each block's same-shape weight
    groups}: the sweep kernel's launches in a BLIP-2 SparseGPT prune."""
    from ecoflap_tpu_torch.models import blip2
    from ecoflap_tpu_torch.pruning.engine import shape_groups

    ad = blip2.make_adapter(model)
    return {stack.name: sum(-(-block.get_submodule(group[0]).weight.shape[1] // 128)
                            for block in stack.blocks(ad.model)
                            for group in shape_groups(block, stack.linear_names))
            for stack in ad.stacks}


def sparsegpt_split(phase_times):
    """{stack: {part: s}} of the SparseGPT fine stage's wall: the whole
    (``s``), the statistics passes, the pruning (with ``prepare_hinv`` and
    the column sweep inside it) and the re-forwards."""
    parts = ("s", "collect_s", "prune_s", "prepare_hinv_s", "sweep_s", "reforward_s")
    return {stack: {p: phase_times[f"fine_{stack}_{p}"] for p in parts}
            for stack in SPARSEGPT_STACKS}


def tiny_blip2_inputs(torch):
    """Tiny BLIP-2, float32 weights made on the CPU (seed 3), and 8
    synthetic samples (seed 0): the inputs of the card-vs-CPU checks of
    the global pruners."""
    from ecoflap_tpu_torch.data import calibration as cal
    from ecoflap_tpu_torch.models import blip2

    cfg = blip2.tiny_config()
    batch = cal.build_vl_calibration_batch(
        cal.synthetic_vl_samples(8, cfg.vit.img_size, 0),
        cal.HashTokenizer(vocab_size=cfg.t5.vocab_size), cal.CalibrationSpec(8, 4), 0)
    return blip2.build_model(cfg, device="cpu", dtype=torch.float32, seed=3), batch


def global_prune_both(torch, name, cfg, model_and_batch, adapter_of):
    """``name`` through ``load_pruner`` on a copy of one model on the card
    and on the CPU; returns {device: (adapter, {target: weight on the CPU})}."""
    from ecoflap_tpu_torch.pruning.loader import load_pruner

    cpu_model, batch = model_and_batch
    out = {}
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(cpu_model).to(dev)
        ad = adapter_of(model)
        load_pruner(name, ad, {k: v.to(dev) for k, v in batch.items()}, 2,
                    dict(cfg, verbose=False)).prune()
        out[dev] = (ad, {t.name: t.weight(model).detach().cpu() for t in ad.targets()})
    return out


def mask_flips(a, b):
    """(entries whose zero pattern differs, entries) over two weight dicts."""
    flips = sum(int(((a[k] == 0) != (b[k] == 0)).sum()) for k in a)
    return flips, sum(v.numel() for v in a.values())


def global_pruner_checks(torch, P, tmp):
    """Phase 9's global-pruner checks, card against CPU (module docstring);
    returns their readings."""
    from ecoflap_tpu_torch.models import blip2, llama
    from ecoflap_tpu_torch.pruning.first_order import first_order_importance
    from ecoflap_tpu_torch.pruning.select import float_bits, kth_smallest_bits

    tiny = tiny_blip2_inputs(torch)
    spec = dict(prune_spec="2-0.5-1.0-1.0", is_global=True)
    out = {}
    # magnitude, 3 steps: |W| is exact on both sides
    res = global_prune_both(torch, "blipt5_global_mag_pruner",
                            dict(spec, iteration=GLOBAL_ITERATIONS), tiny, blip2.make_adapter)
    flips, n = mask_flips(res["cuda"][1], res["cpu"][1])
    assert flips == 0, f"tiny global magnitude card vs CPU: {flips} mask entries differ"
    out["magnitude_flips"] = flips
    # |W| |G|: one step, flips only at near-ties of the CPU's threshold
    res = global_prune_both(torch, "blipt5_global_gradmagabs_pruner",
                            dict(spec, iteration=1), tiny, blip2.make_adapter)
    ad = blip2.make_adapter(copy.deepcopy(tiny[0]))
    imp = first_order_importance(ad.loss_fn, ad.model, tiny[1], 2, ad.targets(),
                                 "GradMagAbs", plans=ad.build_mezo_plans(ad.model, tiny[1]))
    n = sum(v.numel() for v in imp.values())
    thr_bits = kth_smallest_bits([float_bits(v) for v in imp.values()], int(0.5 * n) - 1)
    thr = torch.tensor([thr_bits], dtype=torch.int32).view(torch.float32).item()
    worst = 0.0
    for k, v in imp.items():
        bad = (res["cuda"][1][k] == 0) != (res["cpu"][1][k] == 0)
        if bad.any():
            worst = max(worst, ((v[bad] - thr).abs() / thr).max().item())
    assert worst <= GLOBAL_NEAR_TIE, f"|W| |G| mask flip {worst} from the threshold"
    out["gradmagabs_one_step_flip_distance"] = worst
    res = global_prune_both(torch, "blipt5_global_gradmagabs_pruner",
                            dict(spec, iteration=GLOBAL_ITERATIONS), tiny, blip2.make_adapter)
    flips, n = mask_flips(res["cuda"][1], res["cpu"][1])
    assert flips <= GLOBAL_GRAD_MASK_SHARE * n, f"|W| |G| card vs CPU: {flips} of {n} differ"
    out["gradmagabs_flip_share"] = flips / n
    # MeZO, one seed: whole-tensor masks; kernel 1 three times per target
    # and microbatch on the card (no suffix plans: the serial cycle)
    before = P.perturb_inplace.launches, P.perturb.launches
    t0 = time.time()
    res = global_prune_both(torch, "blipt5_global_mezo_pruner",
                            dict(spec, iteration=1, seed=5, noise_eps=ENSEMBLE_EPS),
                            tiny, blip2.make_adapter)
    made = P.perturb_inplace.launches - before[0], P.perturb.launches - before[1]
    n_targets = len(res["cuda"][1])
    assert made == (3 * n_targets * 2, 0), made
    for k, w in res["cuda"][1].items():
        assert bool((w == 0).all()) or not bool((w == 0).any()), k
    flips, _ = mask_flips(res["cuda"][1], res["cpu"][1])
    assert flips == 0, f"tiny global MeZO card vs CPU: {flips} entries differ"
    out["mezo_kernel1_launches"] = made[0]
    out["mezo_wall_s_both_devices"] = time.time() - t0
    # --coarse_only, Real-GradMagAbs_sum, layer, --prune_per_model, from one
    # --ckpt on both devices
    from ecoflap_tpu_torch.cli import prune as cli
    from ecoflap_tpu_torch.runners.runner import read_flat_yaml
    from ecoflap_tpu_torch.utils.checkpoint import export_state_dict, save_torch_checkpoint

    ckpt = os.path.join(tmp, "tiny_blip2.pth")
    save_torch_checkpoint(export_state_dict(tiny[0]), ckpt)
    dicts = {}
    for dev in ("cuda", "cpu"):
        r = cli.main(["--device", dev, "--model", "blip2_t5", "--model_scale", "tiny",
                      "--ckpt", ckpt, "--prune_spec", "2-0.5-1.0-1.0", "--coarse_only",
                      "--sparsity_ratio_granularity", "layer", "--prune_per_model",
                      "--score_method", "Real-GradMagAbs_sum", "--num_samples", "8",
                      "--batch_size", "4", "--num_data_first_stage", "8",
                      "--output_dir", os.path.join(tmp, dev)])
        dicts[dev] = read_flat_yaml(r["sparsity_dict"])
    numel = {t.name: t.numel(tiny[0]) for t in blip2.make_adapter(tiny[0]).targets()}
    assert set(dicts["cuda"]) == set(dicts["cpu"]) == set(numel)
    flipped = sum(abs(dicts["cuda"][k] - dicts["cpu"][k]) * numel[k] for k in numel)
    assert flipped <= REAL_F32_FLIP_SHARE * sum(numel.values()), flipped
    out["real_coarse_only_flipped_entries"] = flipped
    # SparseGPT from bf16-rounded Hessians
    out["sparsegpt_bf16"] = small_sparsegpt_check(torch, hessian_bf16=True)
    # llama_magnitude_pruner, the two-stage configuration (no --is_global)
    cpu_llama = llama.build_model(llama.tiny_config(), device="cpu", dtype=torch.float32,
                                  seed=3)
    ids = torch.randint(2, 64, (8, 32), generator=torch.Generator().manual_seed(0))
    res = global_prune_both(torch, "llama_magnitude_pruner",
                            dict(prune_spec="2-0.5-1.0-1.0", sparsity_ratio_granularity=None,
                                 stack_specs={"model.layers": "2-0.5-1.0-1.0"}),
                            (cpu_llama, {"input_ids": ids}), llama.make_adapter)
    flips, _ = mask_flips(res["cuda"][1], res["cpu"][1])
    assert flips == 0, f"llama_magnitude_pruner card vs CPU: {flips} entries differ"
    out["llama_magnitude_flips"] = flips
    return out


def small_llama_real_check(torch, A):
    """The small LLaMA of ``small_llama_check``, bf16 on the card (flash
    forward and backward kernels, counted) against f32 on the CPU: the
    ``Real-GradMagAbs_sum`` coarse stage as ``--coarse_only`` runs it
    (``get_sparsity`` of the pruner, block granularity), 2 microbatches of 2
    windows. Returns the worst per-target zero-share difference and the
    card's launches."""
    from ecoflap_tpu_torch.data import calibration as cal
    from ecoflap_tpu_torch.models import llama
    from ecoflap_tpu_torch.pruning.loader import load_pruner

    cfg = small_llama_config(llama)
    cpu_model = llama.build_model(cfg, device="cpu", dtype=torch.float32, seed=3)
    ids = cal.build_lm_calibration_batch(
        cal.synthetic_token_stream(4, 512, cfg.vocab_size, 0), 4, 512, 0)["input_ids"]
    dicts, launches = {}, None
    for dev, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        model = copy.deepcopy(cpu_model).to(dev, dtype)
        ad = llama.make_adapter(model)
        before = A.flash_attention.launches, A.flash_attention_bwd.launches
        pruner = load_pruner("llama_wanda_pruner", ad, {"input_ids": ids.to(dev)}, 2, dict(
            prune_spec="2-0.5-1.0-1.0", sparsity_ratio_granularity="block",
            score_method="Real-GradMagAbs_sum", num_data_first_stage=4, verbose=False))
        with torch.no_grad():
            dicts[dev] = pruner.get_sparsity(0.5, "block")
        if dev == "cuda":
            launches = (A.flash_attention.launches - before[0],
                        A.flash_attention_bwd.launches - before[1])
    # per step and microbatch: the stack's forward and each block's
    # recompute under grad (forward kernel), each block's backward
    steps, mb = 3, 2
    assert launches == (steps * mb * 2 * cfg.num_layers, steps * mb * cfg.num_layers), launches
    worst = max(abs(dicts["cuda"][k] - dicts["cpu"][k]) for k in dicts["cpu"])
    assert worst <= REAL_BF16_SHARE_TOL, f"small LLaMA Real zero shares: {worst}"
    assert abs(sum(dicts["cuda"].values()) / len(dicts["cuda"]) - 0.5) < 0.1
    return worst, launches


def global_xl_argv(pruner_name, out_dir):
    return ["--model", "blip2_t5", "--model_scale", "full", "--seed", str(SEED),
            "--pruning_method", pruner_name, "--prune_spec", GLOBAL_SPEC,
            "--is_global", "--iteration", str(GLOBAL_ITERATIONS),
            "--num_samples", str(NUM_SAMPLES), "--batch_size", str(BATCH_SIZE),
            "--calib", "synthetic", "--output_dir", out_dir]


def check_global_prune(torch, res, bounds):
    """Phases 10-11's gates on the pruned BLIP-2: every prunable weight
    finite, the prunable sparsity inside ``bounds``. Returns each stack's
    zero share."""
    from ecoflap_tpu_torch.models import blip2

    ad = blip2.make_adapter(res["model"])
    shares = {}
    for stack in ad.stacks:
        zeros = total = 0
        for block in stack.blocks(ad.model):
            for local in stack.linear_names:
                w = block.get_submodule(local).weight
                assert torch.isfinite(w).all(), f"{stack.name}: non-finite weight"
                zeros += int((w == 0).sum())
                total += w.numel()
        shares[stack.name] = zeros / total
    lo, hi = bounds
    assert lo <= res["prunable_sparsity"] <= hi, (res["prunable_sparsity"], bounds)
    return shares


def pth_round_trip(torch, res, mod=None, cfg=None):
    """The phase's ``.pth`` loaded by the ``--ckpt`` loader into a freshly
    built model (``mod.build_model(cfg)``, BLIP-2 FlanT5-XL by default; the
    pruned model's dtype, on the card): every tensor equal to the pruned
    model's. Returns (file bytes, read seconds)."""
    from ecoflap_tpu_torch.models import blip2
    from ecoflap_tpu_torch.utils.checkpoint import load_into, load_torch_checkpoint

    if mod is None:
        mod, cfg = blip2, blip2.blip2_flant5xl()
    size = os.path.getsize(res["pth"])
    fresh = mod.build_model(cfg, device="cuda",
                            dtype=next(res["model"].parameters()).dtype, seed=None)
    torch.cuda.synchronize()
    t0 = time.time()
    ignored = load_into(fresh, load_torch_checkpoint(res["pth"]))
    torch.cuda.synchronize()
    read_s = time.time() - t0
    want, got = res["model"].state_dict(), fresh.state_dict()
    assert ignored == 0 and set(want) == set(got)
    bad = [k for k in want if not torch.equal(want[k], got[k])]
    assert not bad, f".pth round trip: {len(bad)} tensors differ, e.g. {bad[:3]}"
    del fresh, got
    return size, read_s


def full_loss_forward_ms(torch, res):
    """Three timed full-loss forwards of the pruned XL model at one
    microbatch of 8 synthetic samples: the unit of the global MeZO
    baseline's cost (2 per target, microbatch and step)."""
    from ecoflap_tpu_torch.data import calibration as cal
    from ecoflap_tpu_torch.models import blip2

    cfg = blip2.blip2_flant5xl()
    batch = cal.build_vl_calibration_batch(
        cal.synthetic_vl_samples(BATCH_SIZE, cfg.vit.img_size, SEED),
        cal.HashTokenizer(vocab_size=cfg.t5.vocab_size),
        cal.CalibrationSpec(BATCH_SIZE, BATCH_SIZE), SEED)
    batch = {k: v.cuda() for k, v in batch.items()}
    ad = blip2.make_adapter(res["model"])
    with torch.no_grad():
        return time_cuda(torch, lambda: ad.loss_fn(ad.model, batch).mean(), 3)


def check_tokens(torch, toks, vocab, what):
    """Generated ids: every one in [0, vocab), only pad (0) after a row's
    first EOS (1). Returns the number of rows that finished."""
    assert toks.dtype == torch.long, (what, toks.dtype)
    assert bool(((toks >= 0) & (toks < vocab)).all()), f"{what}: an id outside the vocab"
    finished = 0
    for row in toks.cpu().tolist():
        if 1 in row:
            finished += 1
            assert set(row[row.index(1) + 1:]) <= {0}, f"{what}: not pad after EOS"
    return finished


def decode_step_bytes(t5):
    """Weight bytes one decode step reads: every decoder weight but the
    cross K/V (made once a sequence) and the relative-position table (read
    once a call), and the lm_head."""
    n = t5.lm_head.weight.numel() * t5.lm_head.weight.element_size()
    for name, p in t5.decoder.named_parameters():
        if not re.search(r"EncDecAttention\.[kv]\.|relative_attention_bias", name):
            n += p.numel() * p.element_size()
    return n


def decode_loop(torch, model, images, ids, mask, point):
    """``Blip2T5.generate``'s work with the decode loop alone between two
    device syncs, run twice on fresh caches (the first warms the allocator
    and cuBLAS at these shapes) to the same tokens: (tokens, the second
    loop's seconds, a callable that runs the loop once more)."""
    import dataclasses

    from ecoflap_tpu_torch.models import generation as G

    t5 = model.t5_model
    cfg = t5.cfg
    gen = dataclasses.replace(G.GenerateConfig(**point), bos_token_id=cfg.decoder_start_token_id,
                              eos_token_id=cfg.eos_token_id, pad_token_id=cfg.pad_token_id)
    run = G.beam_generate if gen.num_beams > 1 else G.greedy_generate
    with torch.inference_mode():
        x, m = model.encoder_inputs(images, ids, mask)
        enc = t5.encode_embeds(x, m)

    def loop():
        with torch.inference_mode():
            cache = G.t5_init_cache(t5, enc, m, gen.max_new_tokens, gen.num_beams)
            step = G.make_t5_step_fn(t5, gen.max_new_tokens, gen.num_beams)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = run(step, cache, images.shape[0], gen, device=images.device)
            torch.cuda.synchronize()
            return toks, time.perf_counter() - t0

    first, _ = loop()
    toks, loop_s = loop()
    assert torch.equal(first, toks), "the decode loop gives other tokens a second time"
    return toks, loop_s, loop


def profile_launches(torch, fn):
    """(CUDA kernel launches, device busy ms) of one call of ``fn`` under
    ``torch.profiler``; the device time is None where the trace holds none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = sum(e.count for e in events if "LaunchKernel" in e.key)
    busy_us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                  for e in events if e.device_type == DeviceType.CUDA)
    return launches, (busy_us / 1e3 if busy_us else None)


def eval_ppl_stream(torch, out_dir):
    """LLaMA-7B (the CLI's seed and dtype) through ``Runner.evaluate`` and
    the ``wikitext_ppl`` task over a random stream of EVAL_PPL_WINDOWS
    windows of 2048 at batch 8. Returns (metrics, wall in s)."""
    import numpy as np

    from ecoflap_tpu_torch.models import llama
    from ecoflap_tpu_torch.runners.runner import Runner
    from ecoflap_tpu_torch.tasks import setup_task

    t0 = time.time()
    cfg = llama.llama_7b()
    model = llama.build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=SEED)
    stream = np.random.default_rng(SEED + 1).integers(
        2, cfg.vocab_size, size=(EVAL_PPL_WINDOWS * LLAMA_SEQLEN,))
    task = setup_task("wikitext_ppl", lambda s: llama.perplexity(
        model, torch.from_numpy(s).cuda(), seqlen=LLAMA_SEQLEN, batch_size=BATCH_SIZE))
    metrics = Runner(out_dir, "eval_llama_stream").evaluate(task, stream)
    del model
    return metrics, time.time() - t0


def eval_xl_checks(torch, cli_batch0):
    """Phase 12's generation checks on the evaluation's model, rebuilt from
    the CLI's seed (the same weights): batch 0 of the CLI's synthetic data
    through ``Blip2T5.generate`` at the VQA point and once more through the
    timed decode loop (the same tokens), then at the captioning point with
    the real-data branch's empty prompt; per-step time against the weight
    bound, launches and device time per step. Returns the readings."""
    import numpy as np

    from ecoflap_tpu_torch.data.calibration import HashTokenizer
    from ecoflap_tpu_torch.models import blip2
    from ecoflap_tpu_torch.models.generation import GenerateConfig

    cfg = blip2.blip2_flant5xl()
    model = blip2.build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=SEED)
    img = cfg.vit.img_size
    rng = np.random.default_rng(SEED)  # the CLI's draw of batch 0
    images = torch.from_numpy(rng.normal(size=(BATCH_SIZE, img, img, 3)).astype(np.float32)).cuda()
    tok = HashTokenizer(vocab_size=cfg.t5.vocab_size)
    ids, mask = (torch.from_numpy(a).cuda() for a in tok(
        [f"question {i}" for i in range(BATCH_SIZE)], max_length=8))
    vocab = cfg.t5.vocab_size
    out = {"step_bytes": decode_step_bytes(model.t5_model)}
    out["bound_ms"] = out["step_bytes"] / HBM_BYTES_PER_S * 1e3
    api = model.generate(images, ids, mask, GenerateConfig(**VQA_POINT))
    assert torch.equal(api, cli_batch0), "batch 0 in the CLI and on the rebuilt model differs"
    toks, loop_s, loop = decode_loop(torch, model, images, ids, mask, VQA_POINT)
    assert torch.equal(api, toks), "batch 0 through generate and the timed loop differs"
    out["vqa_finished"] = check_tokens(torch, toks, vocab, "XL VQA")
    out["vqa_step_ms"] = loop_s / VQA_POINT["max_new_tokens"] * 1e3
    launches, busy_ms = profile_launches(torch, loop)
    out["vqa_launches_per_step"] = launches / VQA_POINT["max_new_tokens"]
    out["vqa_busy_ms_per_step"] = (None if busy_ms is None
                                   else busy_ms / VQA_POINT["max_new_tokens"])
    ids, mask = (torch.from_numpy(a).cuda() for a in tok([""] * BATCH_SIZE, max_length=4))
    toks, loop_s, _ = decode_loop(torch, model, images, ids, mask, CAPTION_POINT)
    out["caption_finished"] = check_tokens(torch, toks, vocab, "XL captioning")
    out["caption_step_ms"] = loop_s / CAPTION_POINT["max_new_tokens"] * 1e3
    del model
    return out


def first_difference_margin(torch, model, images, ids, mask, want, got):
    """Where two token arrays first differ: (row, step, the top-2 logit
    margin of the CPU model's teacher-forced decoder on ``want``'s row)."""
    bad = (want != got).nonzero()
    r, p = int(bad[0, 0]), int(bad[0, 1])
    t5 = model.t5_model
    with torch.no_grad():
        x, m = model.encoder_inputs(images[r:r + 1], ids[r:r + 1], mask[r:r + 1])
        enc = t5.encode_embeds(x, m)
        dec_in = torch.cat([torch.zeros_like(want[r:r + 1, :1]), want[r:r + 1, :-1]], dim=1)
        top2 = t5.decode(enc, m, dec_in)[0, p].topk(2).values
    return r, p, (top2[0] - top2[1]).item()


def tiny_generate_inputs(torch, cfg):
    """Eight random images and ragged, right-padded prompts of up to 8 ids,
    on the CPU, from one seed."""
    g = torch.Generator().manual_seed(6)
    n, img = 8, cfg.vit.img_size
    images = torch.randn(n, img, img, 3, generator=g)
    mask = (torch.arange(8)[None, :] < torch.randint(3, 9, (n, 1), generator=g)).long()
    ids = torch.randint(2, cfg.t5.vocab_size, (n, 8), generator=g) * mask
    return images, ids, mask


def teacher_forced_step_logits(torch, t5, enc, mask, toks):
    """(B, S, V) float32 logits of the cached decode step fed ``toks``
    shifted right behind decoder_start, one position a call."""
    from ecoflap_tpu_torch.models import generation as G

    n, steps = toks.shape
    prev = torch.cat([torch.full_like(toks[:, :1], t5.cfg.decoder_start_token_id),
                      toks[:, :-1]], dim=1)
    with torch.inference_mode():
        cache = G.t5_init_cache(t5, enc, mask, steps, 1)
        step = G.make_t5_step_fn(t5, steps, 1)
        out = []
        for pos in range(steps):
            logits, cache = step(prev[:, pos], pos, cache)
            out.append(logits)
    return torch.stack(out, dim=1)


def tiny_blip2_bf16_check(torch):
    """Tiny BLIP-2 in bf16 with the EOS row of the lm_head raised (rows
    finish): the code that only bf16 runs (the bf16 lm_head product with
    float32 output on the card, the probabilities rounded to bf16, the
    float32 cache of bf16 values). The decode step on the card against the
    same model's step on the CPU, both fed the CPU's encoder output and the
    CPU's greedy tokens over the captioning point's 30 steps: float32 logits
    (not bf16-rounded) within BF16_STEP_LOGITS_REL relative L2. Then beam 5
    and greedy on the card at both points: ids in the vocab, pad after EOS,
    rows finished, and how many rows equal the CPU's (reported: bf16 may
    flip a near-tie). Returns the readings."""
    import dataclasses

    from ecoflap_tpu_torch.models import blip2
    from ecoflap_tpu_torch.models import generation as G
    from ecoflap_tpu_torch.models.generation import GenerateConfig

    cfg = blip2.tiny_config()
    cpu_model = blip2.build_model(cfg, device="cpu", dtype=torch.float32, seed=3)
    with torch.no_grad():
        cpu_model.t5_model.lm_head.weight[cfg.t5.eos_token_id] += EOS_BOOST
    cpu_model = cpu_model.to(torch.bfloat16)
    card = copy.deepcopy(cpu_model).to("cuda")
    images, ids, mask = tiny_generate_inputs(torch, cfg)
    vocab, steps = cfg.t5.vocab_size, CAPTION_POINT["max_new_tokens"]
    t5 = cpu_model.t5_model
    with torch.inference_mode():
        x, m = cpu_model.encoder_inputs(images, ids, mask)
        enc = t5.encode_embeds(x, m)
        gen = dataclasses.replace(GenerateConfig(**dict(CAPTION_POINT, num_beams=1)),
                                  bos_token_id=cfg.t5.decoder_start_token_id,
                                  eos_token_id=cfg.t5.eos_token_id,
                                  pad_token_id=cfg.t5.pad_token_id)
        toks = G.greedy_generate(G.make_t5_step_fn(t5, steps),
                                 G.t5_init_cache(t5, enc, m, steps), ids.shape[0], gen,
                                 device=torch.device("cpu"))
    want = teacher_forced_step_logits(torch, t5, enc, m, toks)
    got = teacher_forced_step_logits(torch, card.t5_model, enc.cuda(), m.cuda(),
                                     toks.cuda()).cpu()
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    # the lm_head's sums stay float32: most logits are no bf16 value
    off_grid = (got != got.to(torch.bfloat16).to(torch.float32)).float().mean().item()
    assert off_grid > 0.5, f"bf16 decode step logits rounded to bf16 ({off_grid:.3f})"
    rel = ((got - want).norm() / want.norm()).item()
    assert rel < BF16_STEP_LOGITS_REL, f"tiny BLIP-2 bf16 step logits card vs CPU: {rel}"
    out = {"step_rel_l2": rel, "off_grid": off_grid, "cases": {}}
    for name, point in (("vqa", VQA_POINT), ("caption", CAPTION_POINT)):
        for nb in (1, point["num_beams"]):
            g = GenerateConfig(**dict(point, num_beams=nb))
            cpu_toks = cpu_model.generate(images, ids, mask, g, use_beam=nb > 1)
            card_toks = card.generate(images.cuda(), ids.cuda(), mask.cuda(), g,
                                      use_beam=nb > 1).cpu()
            case = f"{name} beams {nb}"
            finished = check_tokens(torch, card_toks, vocab, f"bf16 {case}")
            # with the EOS row raised, rows must finish: the finished set and
            # the pad after EOS are what this check is for
            assert finished > 0, f"tiny BLIP-2 bf16 {case}: no row finished"
            same = int((card_toks == cpu_toks).all(dim=1).sum())
            out["cases"][case] = (finished, same)
    return out


def tiny_blip2_generate_check(torch):
    """Tiny BLIP-2 in f32 from one seed on the card and on the CPU (TF32
    off): identical tokens, greedy and beam 5, at the VQA and captioning
    points, at the random init and with the EOS row of the lm_head raised
    (most rows finish). A difference prints its top-2 logit margin and
    fails. Returns {case: rows finished}."""
    from ecoflap_tpu_torch.models import blip2
    from ecoflap_tpu_torch.models.generation import GenerateConfig

    cfg = blip2.tiny_config()
    base = blip2.build_model(cfg, device="cpu", dtype=torch.float32, seed=3)
    images, ids, mask = tiny_generate_inputs(torch, cfg)
    vocab = cfg.t5.vocab_size
    out = {}
    for boost in (0.0, EOS_BOOST):
        cpu_model = copy.deepcopy(base)
        with torch.no_grad():
            cpu_model.t5_model.lm_head.weight[cfg.t5.eos_token_id] += boost
        card = copy.deepcopy(cpu_model).to("cuda")
        for name, point in (("vqa", VQA_POINT), ("caption", CAPTION_POINT)):
            for nb in (1, point["num_beams"]):
                gen = GenerateConfig(**dict(point, num_beams=nb))
                want = cpu_model.generate(images, ids, mask, gen, use_beam=nb > 1)
                got = card.generate(images.cuda(), ids.cuda(), mask.cuda(), gen,
                                    use_beam=nb > 1).cpu()
                case = f"{name} beams {nb} EOS +{boost}"
                if not torch.equal(got, want):
                    r, p, margin = first_difference_margin(torch, cpu_model, images, ids,
                                                           mask, want, got)
                    log(f"tiny BLIP-2 {case}: row {r} differs from step {p}; top-2 "
                        f"logit margin there on the CPU {margin:.3e}")
                    raise AssertionError(f"tiny BLIP-2 generate card vs CPU: {case}")
                out[case] = check_tokens(torch, got, vocab, case)
    return out


def small_llama_ppl_check(torch, A):
    """The small LLaMA of ``small_llama_check``: ``llama.perplexity`` over
    5 windows of 512 at batch 2, bf16 on the card (flash kernel, launches
    counted) against f32 on the CPU, within LLAMA_LOSS_RTOL in log-ppl (the
    token-mean loss). Returns (relative log-ppl difference, launches)."""
    from ecoflap_tpu_torch.data import calibration as cal
    from ecoflap_tpu_torch.models import llama

    cfg = small_llama_config(llama)
    cpu_model = llama.build_model(cfg, device="cpu", dtype=torch.float32, seed=3)
    stream = torch.from_numpy(cal.synthetic_token_stream(4, 512, cfg.vocab_size, 0))
    want = llama.perplexity(cpu_model, stream, seqlen=512, batch_size=2)
    card = copy.deepcopy(cpu_model).to("cuda", torch.bfloat16)
    before = A.flash_attention.launches
    got = llama.perplexity(card, stream.cuda(), seqlen=512, batch_size=2)
    launches = A.flash_attention.launches - before
    windows = stream.shape[0] // 512
    assert launches == -(-windows // 2) * cfg.num_layers, launches
    rel = abs(math.log(got) - math.log(want)) / math.log(want)
    assert math.isfinite(got) and rel < LLAMA_LOSS_RTOL, \
        f"small LLaMA log-ppl card (bf16) vs CPU (f32): rel {rel}"
    return rel, launches


def new_family_checks(torch, P, tmp):
    """Phase 9's checks of the new families at tiny widths, float32, card
    against CPU (module docstring); returns their readings."""
    import numpy as np

    from ecoflap_tpu_torch.cli import prune as cli
    from ecoflap_tpu_torch.cli.evaluate import mmlu_logits_fn
    from ecoflap_tpu_torch.data.calibration import HashTokenizer
    from ecoflap_tpu_torch.models import clip, t5
    from ecoflap_tpu_torch.pruning.loader import load_pruner
    from ecoflap_tpu_torch.runners.runner import read_flat_yaml
    from ecoflap_tpu_torch.utils.checkpoint import export_state_dict, save_torch_checkpoint

    def rel_l2(a, b):
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        return ((a - b).norm() / b.norm()).item()

    out = {}
    cpu_t5 = t5.build_model(t5.tiny_config(), device="cpu", seed=3)
    ckpt = os.path.join(tmp, "tiny_t5.pth")
    save_torch_checkpoint(export_state_dict(cpu_t5), ckpt)
    # zeroth-order through the CLI from one --ckpt: 3 kernel-1 launches per
    # target and coarse microbatch on the card
    zeros, dicts = {}, {}
    for dev in ("cuda", "cpu"):
        before = P.perturb_inplace.launches
        r = cli.main(["--device", dev, "--model", "t5", "--ckpt", ckpt,
                      "--pruning_method", "t5_wanda_pruner", "--prune_spec", "2-0.5-1.0-1.0",
                      "--sparsity_ratio_granularity", "block", "--max_sparsity_per_layer",
                      "0.7", "--num_data_first_stage", "8", "--noise_eps", str(ENSEMBLE_EPS),
                      "--num_samples", "8", "--batch_size", "4",
                      "--output_dir", os.path.join(tmp, f"t5_{dev}")])
        made = P.perturb_inplace.launches - before
        assert made == (3 * (2 * 7 + 2 * 11) * 2 if dev == "cuda" else 0), (dev, made)
        zeros[dev] = {t.name: (t.weight(r["model"]) == 0).cpu()
                      for t in r["pruner"].adapter.targets()}
        dicts[dev] = read_flat_yaml(r["sparsity_dict"])
    assert set(dicts["cuda"]) == set(dicts["cpu"]) and len(dicts["cpu"]) == 36
    for k, v in dicts["cpu"].items():
        assert abs(dicts["cuda"][k] - v) <= NEW_FAMILY_DICT_RTOL * abs(v), (k, v)
    out["t5_wanda_pruner_mask_flip_share"] = mask_flips(zeros["cuda"], zeros["cpu"])[0] / sum(
        v.numel() for v in zeros["cpu"].values())
    # SparseGPT on a batch of random ids: the CLI's synthetic text has five
    # words, so its first blocks' Hessians have rank 5-7 of 32, where the
    # two sides' float32 factors differ by O(1) (as small_sparsegpt_check
    # widens tiny BLIP-2's init); the CLI's own batch is read below
    # (t5_cli_batch_sparsegpt)
    g = torch.Generator().manual_seed(4)
    vocab = cpu_t5.cfg.vocab_size
    batch = {"input_ids": torch.randint(2, vocab, (8, 16), generator=g),
             "attn_mask": torch.ones(8, 16, dtype=torch.long),
             "labels": torch.randint(2, vocab, (8, 16), generator=g)}
    pruned = {}
    for dev in ("cuda", "cpu"):
        ad = t5.make_adapter(copy.deepcopy(cpu_t5).to(dev))
        load_pruner("t5_sparsegpt_pruner", ad, {k: v.to(dev) for k, v in batch.items()}, 2,
                    dict(prune_spec="2-0.5-1.0-1.0", verbose=False)).prune()
        pruned[dev] = {t.name: t.weight(ad.model).detach().cpu() for t in ad.targets()}
    out["t5_sparsegpt_pruner_mask_flip_share"] = mask_flips(pruned["cuda"], pruned["cpu"])[0] / sum(
        v.numel() for v in pruned["cpu"].values())
    for k in ("t5_wanda_pruner_mask_flip_share", "t5_sparsegpt_pruner_mask_flip_share"):
        assert out[k] <= NEW_FAMILY_MASK_SHARE, out
    out["t5_sparsegpt_cli_batch"] = t5_cli_batch_sparsegpt(torch, cli, ckpt, tmp)
    for eva in (False, True):
        name = "eva_clip" if eva else "clip"
        cpu = clip.build_model(clip.tiny_config(eva=eva), device="cpu", seed=3)
        card = copy.deepcopy(cpu).to("cuda")
        g = torch.Generator().manual_seed(5)
        cfg = cpu.cfg
        img = torch.randn(8, cfg.img_size, cfg.img_size, 3, generator=g)
        ids = torch.randint(1, cfg.text.vocab_size, (8, cfg.text.context_length), generator=g)
        ids[:, -1] = cfg.text.vocab_size - 1
        prompts = torch.randint(1, cfg.text.vocab_size - 1,
                                (5 * 2, cfg.text.context_length), generator=g)
        got = {}
        with torch.no_grad():
            for dev, m in (("cuda", card), ("cpu", cpu)):
                loss = m.contrastive_loss({"image": img.to(dev), "text_ids": ids.to(dev)})
                logits = m.predict(img.to(dev), m.zero_shot_classifier(prompts.to(dev), 5))
                got[dev] = (loss, logits)
        out[f"{name}_loss_rel_l2"] = rel_l2(got["cuda"][0], got["cpu"][0])
        out[f"{name}_zero_shot_rel_l2"] = rel_l2(got["cuda"][1], got["cpu"][1])
        assert max(out[f"{name}_loss_rel_l2"], out[f"{name}_zero_shot_rel_l2"]) \
            <= NEW_FAMILY_REL_L2, out
    tok = HashTokenizer(vocab_size=cpu_t5.cfg.vocab_size)
    rng = np.random.default_rng(6)
    prompts = [" ".join(rng.choice(["the", "a", "dog", "A", "B", "C", "D", "x"], 30))
               for _ in range(8)]
    card_t5 = copy.deepcopy(cpu_t5).to("cuda")
    lg = {dev: mmlu_logits_fn(m, tok, torch.device(dev))(prompts)
          for dev, m in (("cuda", card_t5), ("cpu", cpu_t5))}
    out["mmlu_logits_rel_l2"] = rel_l2(lg["cuda"], lg["cpu"])
    assert out["mmlu_logits_rel_l2"] <= NEW_FAMILY_REL_L2, out
    return out


def t5_cli_batch_sparsegpt(torch, cli, ckpt, tmp):
    """``t5_sparsegpt_pruner`` on the prune CLI's own calibration batch of
    tiny T5 (from ``ckpt``; its text has five words): the whole model's mask
    flip share card vs CPU in float32, a reading; then encoder block 0,
    whose Hessians both sides would build from the same inputs: each linear
    pruned from one Hessian on the card and on the CPU, in float32
    (sparsegpt_card_vs_cpu: its objective within SPARSEGPT_XL_RECON_RTOL on
    both sides) and in float64, whose masks must agree up to
    NEW_FAMILY_MASK_SHARE: rounding amplified by near-singular Hessians
    flips float32 masks and shrinks by 2^29 in float64, where a fault on
    the card would flip them all the same. Returns (the whole model's flip
    share, {linear: readings})."""
    from ecoflap_tpu_torch.pruning.sparsegpt import sparsegpt_prune_weight

    common = ["--model", "t5", "--ckpt", ckpt, "--num_samples", "8", "--batch_size", "4"]
    zeros = {}
    for dev in ("cuda", "cpu"):
        r = cli.main(common + ["--device", dev, "--pruning_method", "t5_sparsegpt_pruner",
                               "--prune_spec", "2-0.5-1.0-1.0",
                               "--output_dir", os.path.join(tmp, f"t5_sgpt_{dev}")])
        zeros[dev] = {t.name: t.weight(r["model"]).detach().cpu()
                      for t in r["pruner"].adapter.targets()}
    flips, total = mask_flips(zeros["cuda"], zeros["cpu"])
    ad, batch, _, _ = cli.SETUPS["t5"](cli.build_parser().parse_args(common),
                                       torch.device("cuda"), torch.float32)
    stack = next(s for s in ad.stacks if s.name == "encoder.block")
    block = stack.blocks(ad.model)[0]
    with torch.no_grad():
        x, cache = stack.prepare_inputs(ad.model, {k: v.cuda() for k, v in batch.items()})
        _, stats = stack.block_forward(block, x, cache, "hessian")
    block0 = {}
    for local in stack.linear_names:
        w = block.get_submodule(local).weight.detach().to(torch.float32)
        h = (2.0 / x.shape[0]) * stats[local].to(torch.float32)
        r = sparsegpt_card_vs_cpu(torch, w, h, 0.5, local)
        card = sparsegpt_prune_weight(w.double(), h.double(), 0.5)
        cpu = sparsegpt_prune_weight(w.double().cpu(), h.double().cpu(), 0.5).cuda()
        r["mask_share_f64"] = ((card == 0) != (cpu == 0)).float().mean().item()
        assert r["mask_share_f64"] <= NEW_FAMILY_MASK_SHARE, (local, r)
        block0[local] = r
    return flips / total, block0


def t5_xl_path(torch, cli, kernels, out_dir, read_flat_yaml):
    """Phase 14; returns (counts, readings)."""
    from ecoflap_tpu_torch.models import t5

    pth_dir = tempfile.mkdtemp(prefix="chip_smoke_t5_")
    try:
        argv = ["--cfg-path", T5_CFG_PATH, "--options",
                f"prune.num_data_first_stage={T5_FIRST_STAGE}",
                "--output_dir", pth_dir, "--save_pruned_model"]
        res, wall, counts = run_path(cli, kernels, argv)
        log_path("FlanT5-XL standalone", res, wall, counts)
        # no suffix plans: the serial in-place cycle, 3 launches a target
        assert counts == {"perturb_inplace": 3 * T5_TARGETS * (T5_FIRST_STAGE // BATCH_SIZE),
                          "perturb": 0, "flash_attention": 0,
                          "flash_attention_bwd": 0}, counts
        assert res["job_id"] == "t5_wanda_pruner_24-0.5-1.0-1.0_MEZO-GradOnly_avg_block", res
        vals, sd = check_scores_and_dict(read_flat_yaml, res, T5_TARGETS, 0.6, 0.5)
        assert res["peak_gib"] <= T5_PEAK_GIB, res["peak_gib"]
        size, read_s = pth_round_trip(torch, res, t5, t5.flan_t5_xl())
        info = {"wall": wall, "prune": res["wall_clock_s"], "peak": res["peak_gib"],
                "scores": (min(vals), max(vals)), "max_ratio": max(sd.values()),
                "sparsity": res["prunable_sparsity"], "pth_bytes": size,
                "pth_write_s": res["pth_write_s"], "pth_read_s": read_s}
        del res
    finally:
        shutil.rmtree(pth_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return counts, info


def mmlu_xl(torch, kernels, out_dir):
    """Phase 15; returns (counts, readings)."""
    import numpy as np

    from ecoflap_tpu_torch.cli import evaluate as ev
    from ecoflap_tpu_torch.data.calibration import HashTokenizer
    from ecoflap_tpu_torch.models import t5
    from ecoflap_tpu_torch.runners.runner import Runner
    from ecoflap_tpu_torch.tasks import setup_task
    from ecoflap_tpu_torch.tasks.mmlu import CHOICES, SUBCATEGORIES

    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    t0 = time.time()
    cli_res = ev.main(["--model", "t5", "--task", "mmlu", "--model_scale", "full",
                       "--synthetic", "--seed", str(SEED), "--output_dir", out_dir])
    cli_wall = time.time() - t0
    assert 0.0 <= cli_res["acc/college_physics"] <= 1.0, cli_res
    gc.collect()
    torch.cuda.empty_cache()
    model = t5.build_model(t5.flan_t5_xl(), device="cuda", dtype=torch.bfloat16, seed=SEED)
    tok = HashTokenizer(vocab_size=model.cfg.vocab_size)
    abcd = [tok._word_id(c) for c in CHOICES]
    # the task's own length budget: every prompt reaches the encoder whole
    fn = ev.mmlu_logits_fn(model, tok, torch.device("cuda"), max_length=MMLU_MAX_TOKENS)
    rng = np.random.default_rng(SEED)

    words = np.array("the of which a is in that for energy law cell value state market "
                     "theory force number set case group rate model function".split())

    def text(lo, hi):
        return " ".join(rng.choice(words, int(rng.integers(lo, hi + 1))))

    # questions of MMLU_QUESTION_WORDS and choices of MMLU_CHOICE_WORDS words
    def rows(subject, tag, n):
        return [[f"{tag}{i} {text(*MMLU_QUESTION_WORDS)} {subject.replace('_', ' ')}?",
                 *(text(*MMLU_CHOICE_WORDS) for _ in CHOICES),
                 CHOICES[int(rng.integers(0, 4))]] for i in range(n)]

    data = {s: {"dev": rows(s, "q", MMLU_SHOTS), "test": rows(s, "t", MMLU_TEST_PER_SUBJECT)}
            for s in SUBCATEGORIES}
    walls, logits, seen = [], [], []

    def token_len(s):
        return len(tok([s], max_length=10_000, pad=False)[0][0])

    def recording(prompts):
        t1 = time.time()
        lg = fn(prompts).float().cpu()  # the one wait for the card
        walls.append(time.time() - t1)
        logits.append(lg)
        seen.append(list(prompts))
        return lg

    task = setup_task("mmlu", recording, abcd, token_len_fn=token_len,
                      max_tokens=MMLU_MAX_TOKENS)
    runner = Runner(out_dir, "mmlu_xl_stream")
    passes = []
    for _ in range(2):
        walls.clear()
        logits.clear()
        seen.clear()
        t1 = time.time()
        m = runner.evaluate(task, data)
        wall = time.time() - t1
        # no prompt was cut: the test question, last in each, reached the encoder
        lengths = [[token_len(p) for p in batch] for batch in seen]
        assert sum(map(len, lengths)) == len(SUBCATEGORIES) * MMLU_TEST_PER_SUBJECT
        assert max(map(max, lengths)) <= MMLU_MAX_TOKENS, max(map(max, lengths))
        assert all(bool(torch.isfinite(lg).all()) for lg in logits), "non-finite logits"
        preds = torch.cat([lg[:, abcd].argmax(-1) for lg in logits])
        passes.append((m, wall, list(walls), preds))
    (m1, wall1, walls1, p1), (m2, _, _, p2) = passes
    n = len(SUBCATEGORIES) * MMLU_TEST_PER_SUBJECT
    assert p1.shape == (n,) and torch.equal(p1, p2), "MMLU predictions differ between passes"
    assert all(0.0 <= v <= 1.0 for k, v in m1.items() if k.startswith("acc/")), m1
    assert {k: v for k, v in m1.items() if k != "eval_time_s"} == \
        {k: v for k, v in m2.items() if k != "eval_time_s"}
    counts = read_counts(kernels)
    assert not any(counts.values()), counts
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return counts, {"cli": cli_res, "cli_wall": cli_wall, "agg": m1["agg_metrics"],
                    "prompts": n, "wall": wall1, "walls": walls1,
                    "prompts_per_s": n / wall1, "peak": peak,
                    "tokens": (min(map(min, lengths)), sum(map(sum, lengths)) / n,
                               max(map(max, lengths))),
                    "padded": sum(map(max, lengths)) / len(lengths),
                    "pred_counts": torch.bincount(p1, minlength=4).tolist()}


def zero_shot_run(torch, kernels, model, prompts, num_classes, out_dir, tag):
    """Zero-shot classification of ``model`` on the card: the classifier of
    ``prompts`` (hash tokens), then ZS_BATCHES batches of ZS_BATCH synthetic
    images through the task and ``Runner.evaluate``; counts read around it."""
    import numpy as np

    from ecoflap_tpu_torch.cli.evaluate import zero_shot_predict_fn
    from ecoflap_tpu_torch.data.calibration import HashTokenizer
    from ecoflap_tpu_torch.runners.runner import Runner
    from ecoflap_tpu_torch.tasks import setup_task

    reset_counts(kernels)
    cfg = model.cfg
    ids, _ = HashTokenizer(vocab_size=cfg.text.vocab_size)(
        prompts, max_length=cfg.text.context_length)
    ids = torch.from_numpy(ids).cuda()
    torch.cuda.synchronize()
    t0 = time.time()
    classifier = model.zero_shot_classifier(ids, num_classes)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    assert classifier.shape == (cfg.embed_dim, num_classes), classifier.shape
    norms = classifier.float().norm(dim=0)
    assert bool(torch.isfinite(norms).all()) and (norms - 1).abs().max().item() < 1e-2, norms
    rng = np.random.default_rng(SEED)
    img = cfg.img_size
    batches = [{"image": rng.normal(size=(ZS_BATCH, img, img, 3)).astype(np.float32),
                "label": rng.integers(0, num_classes, size=(ZS_BATCH,))}
               for _ in range(ZS_BATCHES)]
    predict = zero_shot_predict_fn(model, classifier, torch.device("cuda"))

    def checked(batch):
        lg = predict(batch)
        assert lg.shape == (ZS_BATCH, num_classes) and bool(torch.isfinite(lg).all())
        return lg

    t0 = time.time()
    m = Runner(out_dir, f"zero_shot_{tag}").evaluate(
        setup_task("multimodal_classification", checked), batches)
    wall = time.time() - t0
    assert 0.0 <= m["agg_metrics"] <= 100.0, m
    counts = read_counts(kernels)
    assert not any(counts.values()), counts
    return {"prompts": len(prompts), "build_s": build_s, "eval_wall": wall,
            "images_per_s": ZS_BATCHES * ZS_BATCH / wall, "agg": m["agg_metrics"]}


def eva_clip_path(torch, cli, kernels, out_dir, read_flat_yaml):
    """Phase 16; returns (counts, readings)."""
    from ecoflap_tpu_torch.data.prompts import OPENAI_IMAGENET_TEMPLATES, build_prompts
    from ecoflap_tpu_torch.utils.checkpoint import load_torch_checkpoint

    pth_dir = tempfile.mkdtemp(prefix="chip_smoke_eva_")
    try:
        argv = ["--cfg-path", EVA_CFG_PATH, "--options",
                f"prune.num_data_first_stage={EVA_FIRST_STAGE}",
                "--output_dir", pth_dir, "--save_pruned_model"]
        res, wall, counts = run_path(cli, kernels, argv)
        log_path("EVA-CLIP-g", res, wall, counts)
        assert counts == {"perturb_inplace": 3 * EVA_TARGETS * (EVA_FIRST_STAGE // BATCH_SIZE),
                          "perturb": 0, "flash_attention": 0,
                          "flash_attention_bwd": 0}, counts
        vals, sd = check_scores_and_dict(read_flat_yaml, res, EVA_TARGETS, 0.6, 0.5)
        assert all(k.startswith("visual.blocks.") for k in sd), "EVA-CLIP prunes its visual tower"
        assert res["peak_gib"] <= EVA_PEAK_GIB, res["peak_gib"]
        # the export: the visual tower without block 39, every tensor the
        # pruned model's
        t0 = time.time()
        state = load_torch_checkpoint(res["pth"])
        own = res["model"].state_dict()
        want = {k for k in own if k.startswith("visual.") and "blocks.39." not in k}
        assert set(state) == want, sorted(set(state) ^ want)[:5]
        bad = [k for k in want if not torch.equal(state[k], own[k].float().cpu())]
        assert not bad, bad[:3]
        read_s = time.time() - t0
        info = {"wall": wall, "prune": res["wall_clock_s"], "peak": res["peak_gib"],
                "scores": (min(vals), max(vals)), "max_ratio": max(sd.values()),
                "sparsity": res["prunable_sparsity"], "pth_bytes": os.path.getsize(res["pth"]),
                "pth_keys": len(state), "pth_write_s": res["pth_write_s"],
                "pth_read_s": read_s}
        del state, own
        classnames = [f"synthetic class {i}" for i in range(ZS_CLASSES)]
        info["zero_shot"] = zero_shot_run(
            torch, kernels, res["model"], build_prompts(classnames, OPENAI_IMAGENET_TEMPLATES),
            ZS_CLASSES, out_dir, "eva_clip")
        del res
    finally:
        shutil.rmtree(pth_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return counts, info


def clip_path(torch, cli, kernels, out_dir, read_flat_yaml):
    """Phase 17; returns (counts, readings)."""
    from ecoflap_tpu_torch.data.coop import coop_prompts

    argv = ["--model", "clip", "--model_scale", "full", "--seed", str(SEED),
            "--pruning_method", "clip_wanda_pruner", "--prune_spec", "12-0.6-1.0-1.0",
            "--sparsity_ratio_granularity", "block", "--score_method", "MEZO-GradOnly_sum",
            "--max_sparsity_per_layer", "0.5", "--num_samples", str(CLIP_SAMPLES),
            "--batch_size", str(CLIP_BATCH), "--num_data_first_stage", str(CLIP_SAMPLES),
            "--output_dir", out_dir]
    res, wall, counts = run_path(cli, kernels, argv)
    log_path("CLIP ViT-B/16", res, wall, counts)
    assert counts == {"perturb_inplace": 3 * CLIP_TARGETS * (CLIP_SAMPLES // CLIP_BATCH),
                      "perturb": 0, "flash_attention": 0, "flash_attention_bwd": 0}, counts
    vals, sd = check_scores_and_dict(read_flat_yaml, res, CLIP_TARGETS, 0.5, 0.4)
    assert res["peak_gib"] <= CLIP_PEAK_GIB, res["peak_gib"]
    info = {"wall": wall, "prune": res["wall_clock_s"], "peak": res["peak_gib"],
            "scores": (min(vals), max(vals)), "max_ratio": max(sd.values()),
            "sparsity": res["prunable_sparsity"]}
    classnames = [f"synthetic class {i}" for i in range(ZS_CLASSES)]
    info["zero_shot"] = zero_shot_run(torch, kernels, res["model"],
                                      coop_prompts("imagenet", classnames), ZS_CLASSES,
                                      out_dir, "clip")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return counts, info


def blip1_tiny_checks(torch, P, tmp):
    """Phase 9's BLIP-1 checks: each of the four heads at tiny width, f32,
    card against CPU, from one model (kernels ``BLIP1_TINY_KERNEL_SCALE``
    times the init): the per-sample loss, then the UPop launcher
    (``cli/upop.py``) on both devices from one ``--ckpt``, kernel 1 on the
    card: sparsity dicts within ``NEW_FAMILY_DICT_RTOL``, mask flips within
    ``NEW_FAMILY_MASK_SHARE``. Returns the readings."""
    from ecoflap_tpu_torch.cli import upop
    from ecoflap_tpu_torch.models import blip1
    from ecoflap_tpu_torch.utils.checkpoint import export_state_dict, save_torch_checkpoint

    out = {}
    for head, kind in upop.HEADS.items():
        cpu = blip1.build_model(blip1.tiny_config(), kind, device="cpu", seed=3)
        with torch.no_grad():
            for name, mod in cpu.named_modules():
                # every linear but the LM head's decoder, tied to the embedding
                if isinstance(mod, torch.nn.Linear) and not name.endswith("decoder"):
                    mod.weight.mul_(BLIP1_TINY_KERNEL_SCALE)
        card = copy.deepcopy(cpu).to("cuda")
        batch = upop.build_batch(head, cpu.cfg, 4)
        with torch.no_grad():
            loss = {dev: m.per_sample_loss({k: torch.from_numpy(v).to(dev)
                                            for k, v in batch.items()}).cpu()
                    for dev, m in (("cuda", card), ("cpu", cpu))}
        rel = ((loss["cuda"] - loss["cpu"]).norm() / loss["cpu"].norm()).item()
        assert rel <= NEW_FAMILY_REL_L2, (head, rel)
        ckpt = os.path.join(tmp, f"tiny_blip1_{head}.pth")
        save_torch_checkpoint(export_state_dict(cpu), ckpt)
        zeros, dicts, made = {}, {}, {}
        t0 = time.time()
        for dev in ("cuda", "cpu"):
            before = P.perturb_inplace.launches
            r = upop.main(["--head", head, "--device", dev, "--ckpt", ckpt, "--num_samples",
                           str(BLIP1_TINY_SAMPLES), "--noise_eps", str(BLIP1_TINY_EPS)])
            targets = r["adapter"].targets()
            want = 3 * len(targets) * (BLIP1_TINY_SAMPLES // BLIP1_MICROBATCH)
            made[dev] = P.perturb_inplace.launches - before
            assert made[dev] == (want if dev == "cuda" else 0), (head, dev, made)
            zeros[dev] = {t.name: (t.weight(r["model"]) == 0).cpu() for t in targets}
            dicts[dev] = r["sparsity_dict"]
        assert set(dicts["cuda"]) == set(dicts["cpu"]) == set(zeros["cpu"]), head
        for k, v in dicts["cpu"].items():
            assert abs(dicts["cuda"][k] - v) <= NEW_FAMILY_DICT_RTOL * abs(v), (head, k, v)
        flips, n = mask_flips(zeros["cuda"], zeros["cpu"])
        out[head] = {"loss_rel_l2": rel, "mask_flip_share": flips / n,
                     "launches": made["cuda"], "sparsity": r["sparsity"],
                     "wall": time.time() - t0}
        assert flips / n <= NEW_FAMILY_MASK_SHARE, (head, out[head])
    return out


def blip1_path(torch, kernels, out_dir):
    """Phase 18: the UPop caption run at ``blip_base`` width through
    ``cli/upop.py`` (prune, 2 masked AdamW steps, the pruned ``.pth``), its
    checks, the ``.pth`` read back tensor by tensor and the evaluate CLI's
    captioning from it. Returns (prune counts, eval counts, readings)."""
    from ecoflap_tpu_torch.cli import evaluate as ev
    from ecoflap_tpu_torch.cli import upop
    from ecoflap_tpu_torch.models import blip1
    from ecoflap_tpu_torch.runners import finetune as ft
    from ecoflap_tpu_torch.utils.checkpoint import load_into, load_torch_checkpoint

    pth_dir = tempfile.mkdtemp(prefix="chip_smoke_blip1_")
    pth = os.path.join(pth_dir, "blip1_caption_pruned.pth")
    # the masks the launcher freezes, and the weights they were frozen from
    frozen, make_masks = {}, ft.make_sparsity_masks

    def recording_masks(model):
        frozen["weights"] = {n: p.detach().clone() for n, p in model.named_parameters()}
        frozen["masks"] = make_masks(model)
        return frozen["masks"]

    ft.make_sparsity_masks = recording_masks
    try:
        res, wall, counts = run_path(upop, kernels, [
            "--head", "caption", "--model_scale", "full", "--seed", str(SEED), "--p", "0.5",
            "--num_samples", str(BLIP1_SAMPLES), "--finetune_steps", str(BLIP1_FT_STEPS),
            "--save_pruned", pth])
    finally:
        ft.make_sparsity_masks = make_masks
    try:
        n_mb = BLIP1_SAMPLES // BLIP1_MICROBATCH
        assert counts == {"perturb_inplace": 3 * BLIP1_TARGETS * n_mb, "perturb": 0,
                          "flash_attention": 0, "flash_attention_bwd": 0}, counts
        model, sd = res["model"], res["sparsity_dict"]
        scores = res["pruner"].leaf_scores
        keys = {t.name for t in res["adapter"].targets()}
        assert len(keys) == BLIP1_TARGETS and set(sd) == set(scores) == keys, "BLIP-1 keys"
        vals = list(scores.values())
        assert all(math.isfinite(v) and v >= 0 for v in vals) and len(set(vals)) > 1, \
            "BLIP-1 coarse scores"
        assert max(sd.values()) <= 0.6 + 1e-9, max(sd.values())
        assert abs(res["sparsity"] - 0.5) <= 0.01, res["sparsity"]
        assert res["peak_gib"] <= BLIP1_PEAK_GIB, res["peak_gib"]
        assert all(math.isfinite(v) for v in (res["ft_loss_first"], res["ft_loss_last"]))
        changed = kept = 0
        for n, p in model.named_parameters():
            m, w0 = frozen["masks"][n], frozen["weights"][n]
            assert not p[~m].any(), f"{n}: a pruned entry moved in the fine-tune"
            changed += int((p[m] != w0[m]).sum())
            kept += int(m.sum())
        info = {"wall": wall, "prune": res["prune_s"], "phases": res["phase_times"],
                "ft_s": res["finetune_s_per_step"], "peak": res["peak_gib"],
                "scores": (min(vals), max(vals)), "max_ratio": max(sd.values()),
                "sparsity": res["sparsity"], "ft_losses": (res["ft_loss_first"],
                                                           res["ft_loss_last"]),
                "changed_share": changed / kept}
        t0 = time.time()
        state = load_torch_checkpoint(pth)
        own = model.state_dict()
        assert set(state) == set(own), sorted(set(state) ^ set(own))[:5]
        bad = [k for k in own if not torch.equal(state[k], own[k].float().cpu())]
        assert not bad, bad[:3]
        fresh = blip1.build_model(blip1.blip_base(), "blip_caption", device="cuda",
                                  dtype=torch.bfloat16, seed=None)
        load_into(fresh, state)
        assert all(torch.equal(v, own[k]) for k, v in fresh.state_dict().items())
        info.update(pth_bytes=os.path.getsize(pth), pth_keys=len(state),
                    pth_read_s=time.time() - t0)
        del state, own, fresh, res, model, frozen
        gc.collect()
        torch.cuda.empty_cache()

        # the captioning eval from the .pth, each generate call timed
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        walls, generate = [], blip1.BlipCaption.generate

        def timed_generate(self, *a, **kw):
            torch.cuda.synchronize()
            t = time.time()
            toks = generate(self, *a, **kw)
            torch.cuda.synchronize()
            walls.append(time.time() - t)
            assert toks.shape == (BLIP1_MICROBATCH, BLIP1_CAPTION_POINT["max_new_tokens"])
            assert bool(((toks >= 0) & (toks < self.cfg.text.vocab_size)).all())
            return toks

        blip1.BlipCaption.generate = timed_generate
        t0 = time.time()
        try:
            cap = ev.main(["--model", "blip1", "--task", "captioning", "--model_scale", "full",
                           "--checkpoint", pth, "--batch_size", str(BLIP1_MICROBATCH),
                           "--eval_batches", str(BLIP1_EVAL_BATCHES),
                           "--num_beams", str(BLIP1_CAPTION_POINT["num_beams"]),
                           "--max_new_tokens", str(BLIP1_CAPTION_POINT["max_new_tokens"]),
                           "--length_penalty", str(BLIP1_CAPTION_POINT["length_penalty"]),
                           "--seed", str(SEED), "--output_dir", out_dir])
        finally:
            blip1.BlipCaption.generate = generate
        eval_counts = read_counts(kernels)
        assert not any(eval_counts.values()), eval_counts  # BERT attention is naive
        assert len(walls) == BLIP1_EVAL_BATCHES and "agg_metrics" in cap, cap
        info.update(eval_wall=time.time() - t0, eval_s=cap["eval_time_s"],
                    generate_s=walls, eval_peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                    token_ms=1e3 * min(walls) / BLIP1_CAPTION_POINT["max_new_tokens"])
    finally:
        shutil.rmtree(pth_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return counts, eval_counts, info


def slice12_tiny_checks(torch):
    """Phase 9's checks of the image classifiers, BLIP-2 OPT and the stage-1
    Q-Former at tiny widths, float32, card against CPU from one model each
    (module docstring); returns the readings."""
    from ecoflap_tpu_torch.models import blip2_opt, blip2_qformer, classifiers
    from ecoflap_tpu_torch.models.generation import GenerateConfig

    def rel_l2(a, b):
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        return ((a - b).norm() / b.norm()).item()

    out = {}
    g = torch.Generator().manual_seed(7)
    for kind in ("deit", "convnext"):
        cpu = classifiers.build_model(classifiers.build(kind, "tiny"), device="cpu", seed=3)
        if kind == "convnext":
            with torch.no_grad():
                for stage in cpu.stages:
                    for blk in stage:
                        blk.gamma.uniform_(*CONVNEXT_GAMMA, generator=g)
        card = copy.deepcopy(cpu).to("cuda")
        img = torch.randn(8, cpu.cfg.img_size, cpu.cfg.img_size, 3, generator=g)
        label = torch.randint(0, classifiers.num_classes(cpu.cfg), (8,), generator=g)
        got = {}
        with torch.no_grad():
            for dev, m in (("cuda", card), ("cpu", cpu)):
                batch = {"image": img.to(dev), "label": label.to(dev)}
                got[dev] = (m(batch["image"]), classifiers.make_adapter(m).loss_fn(m, batch))
        out[f"{kind}_logits_rel_l2"] = rel_l2(got["cuda"][0], got["cpu"][0])
        out[f"{kind}_loss_rel_l2"] = rel_l2(got["cuda"][1], got["cpu"][1])
        assert max(out[f"{kind}_logits_rel_l2"], out[f"{kind}_loss_rel_l2"]) \
            <= NEW_FAMILY_REL_L2, out
    cpu = blip2_opt.build_model(blip2_opt.tiny_config(), device="cpu", seed=3)
    with torch.no_grad():
        for mod in cpu.modules():
            if isinstance(mod, torch.nn.Linear):
                mod.weight.mul_(OPT_TINY_KERNEL_SCALE)
        cpu.visual_encoder.patch_embed.proj.weight.mul_(OPT_TINY_KERNEL_SCALE)
        dec = cpu.opt_model.decoder
        v = torch.randn(dec.final_layer_norm.bias.shape, generator=g)
        dec.final_layer_norm.bias.copy_(0.5 * v)
        dec.embed_tokens.weight[cpu.cfg.opt.eos_token_id] += OPT_TINY_EOS_BOOST * v
    card = copy.deepcopy(cpu).to("cuda")
    img = torch.randn(6, 16, 16, 3, generator=g)
    prompt = torch.randint(3, cpu.cfg.opt.vocab_size, (1, OPT_PROMPT_TOKENS),
                           generator=g).repeat(6, 1)
    for name, beams in (("greedy", 1), ("beam5", 5)):
        gen = GenerateConfig(max_new_tokens=12, num_beams=beams, min_length=8)
        toks = {dev: m.generate(img.to(dev), prompt.to(dev), torch.ones_like(prompt).to(dev),
                                gen).cpu()
                for dev, m in (("cuda", card), ("cpu", cpu))}
        assert torch.equal(toks["cuda"], toks["cpu"]), (name, toks)
        out[f"blip2_opt_{name}_finished"] = sum(
            cpu.cfg.opt.eos_token_id in r for r in toks["cpu"].tolist())
        # rows that finish are what exercise min_length and pad after EOS
        # (phase 21's full-width rows run to max_new_tokens)
        assert out[f"blip2_opt_{name}_finished"] >= 1, (name, toks["cpu"])
    cpu = blip2_qformer.build_model(blip2_qformer.tiny_config(), device="cpu", seed=3)
    card = copy.deepcopy(cpu).to("cuda")
    emb = torch.randn(6, 8, cpu.cfg.qformer.encoder_width, generator=g)
    ids = torch.randint(3, cpu.cfg.vocab_size, (6, 8), generator=g)
    mask = torch.ones_like(ids)
    mask[1, 5:] = 0
    got = {}
    with torch.no_grad():
        for dev, m in (("cuda", card), ("cpu", cpu)):
            args = (emb.to(dev), ids.to(dev), mask.to(dev))
            got[dev] = (m.itc_sim_matrix(*args), m.itm_score(*args))
    out["qformer_sims_rel_l2"] = rel_l2(got["cuda"][0], got["cpu"][0])
    out["qformer_itm_rel_l2"] = rel_l2(got["cuda"][1], got["cpu"][1])
    assert max(out["qformer_sims_rel_l2"], out["qformer_itm_rel_l2"]) <= NEW_FAMILY_REL_L2, out
    return out


def classifier_path(torch, kernels, out_dir, read_flat_yaml, kind, keep=False):
    """Phase 19 (``deit``, DeiT-B) or 20 (``convnext``, ConvNeXt-T): a
    reference-named ``.pth`` of the seed's weights (timm's names with the
    head scaled by ``DEIT_HEAD_SCALE``, or FB's with layer scales from
    U``CONVNEXT_GAMMA``), pruned through the prune
    CLI with the launcher's flags (Wanda, uniform), then again with the
    ECoFLaP block MeZO stage (kernel 1 counted) and ``--save_pruned_model``;
    that ``.pth`` read back tensor by tensor, then classified on random
    images through the evaluate CLI. Returns the readings and counts; with
    ``keep`` the folder stays, and ``out["kept"]`` names its checkpoint, the
    ECoFLaP run's argv, dict and ``.pth`` (phase 23 reruns that run), and
    holds a head planted on the eval's images (``plant_head``)."""
    from ecoflap_tpu_torch.cli import evaluate as ev
    from ecoflap_tpu_torch.cli import prune as cli
    from ecoflap_tpu_torch.models import classifiers
    from ecoflap_tpu_torch.utils.checkpoint import (
        export_state_dict,
        load_torch_checkpoint,
        save_torch_checkpoint,
    )

    pth_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{kind}_")
    out = {}
    try:
        model = classifiers.build_model(classifiers.build(kind, "full"), device="cuda",
                                        seed=SEED)
        with torch.no_grad():
            if kind == "convnext":
                g = torch.Generator(device="cuda").manual_seed(SEED)
                for stage in model.stages:
                    for blk in stage:
                        blk.gamma.uniform_(*CONVNEXT_GAMMA, generator=g)
            else:
                model.head.weight.mul_(DEIT_HEAD_SCALE)
        ckpt = os.path.join(pth_dir, f"{kind}_seed{SEED}.pth")
        save_torch_checkpoint(export_state_dict(model), ckpt)
        del model
        argv = ["--model", kind, "--model_scale", "full", "--ckpt", ckpt,
                "--pruning_method", f"{kind}_wanda_pruner", "--prune_spec", CLS_SPECS[kind],
                "--num_samples", str(CLS_SAMPLES), "--batch_size", str(CLS_BATCH),
                "--seed", str(SEED)]
        torch.cuda.reset_peak_memory_stats()
        res, wall, counts = run_path(cli, kernels, argv + ["--output_dir", pth_dir])
        log_path(f"{CLS_NAMES[kind]} Wanda", res, wall, counts)
        assert not any(counts.values()), counts
        assert abs(res["prunable_sparsity"] - 0.5) <= 0.01, res["prunable_sparsity"]
        out["wanda"] = {"wall": wall, "prune": res["wall_clock_s"],
                        "sparsity": res["prunable_sparsity"]}
        out["wanda_counts"] = counts
        del res
        n = CLS_TARGETS[kind]
        res, wall, counts = run_path(cli, kernels, argv + CLS_ECOFLAP + [
            "--save_pruned_model", "--output_dir", pth_dir])
        log_path(f"{CLS_NAMES[kind]} ECoFLaP", res, wall, counts)
        assert counts == {"perturb_inplace": 3 * n * (CLS_FIRST_STAGE // CLS_BATCH),
                          "perturb": 0, "flash_attention": 0, "flash_attention_bwd": 0}, counts
        scores = list(res["leaf_scores"].values())
        assert len(scores) == n and all(math.isfinite(v) and v >= 0 for v in scores), scores
        nonzero = [v for v in scores if v > 0]
        assert (len(nonzero) >= CLS_MIN_NONZERO * n
                and len(set(nonzero)) >= CLS_MIN_DISTINCT), sorted(scores)
        sd = read_flat_yaml(res["sparsity_dict"])
        assert set(sd) == set(res["leaf_scores"]), "sparsity dict keys"
        assert max(sd.values()) <= 0.6 + 1e-9, max(sd.values())
        assert abs(res["prunable_sparsity"] - 0.5) <= 0.01, res["prunable_sparsity"]
        t0 = time.time()
        state = load_torch_checkpoint(res["pth"])
        own = res["model"].state_dict()
        assert set(state) == set(own), sorted(set(state) ^ set(own))[:5]
        bad = [k for k in own if not torch.equal(state[k], own[k].float().cpu())]
        assert not bad, bad[:3]
        out["ecoflap"] = {
            "wall": wall, "prune": res["wall_clock_s"], "peak": res["peak_gib"],
            "scores": (min(scores), max(scores)), "distinct_nonzero": len(set(nonzero)),
            "zero_scores": sum(v == 0 for v in scores), "max_ratio": max(sd.values()),
            "sparsity": res["prunable_sparsity"], "pth_bytes": os.path.getsize(res["pth"]),
            "pth_write_s": res["pth_write_s"], "pth_read_s": time.time() - t0}
        out["ecoflap_counts"] = counts
        pth = res["pth"]
        out["kept"] = {"dir": pth_dir, "argv": argv + CLS_ECOFLAP, "pth": pth,
                       "sparsity_dict": res["sparsity_dict"]}
        del res, state, own
        gc.collect()
        recorded, predict_fn = [], ev.classifier_predict_fn

        def recording(model, device):
            fn = predict_fn(model, device)

            def predict(batch):
                recorded.append((model, batch))
                return fn(batch)

            return predict

        ev.classifier_predict_fn = recording
        reset_counts(kernels)
        t0 = time.time()
        try:
            metrics = ev.main(["--model", kind, "--task", "classification", "--model_scale",
                               "full", "--synthetic", "--checkpoint", pth, "--batch_size",
                               str(CLS_BATCH), "--output_dir", pth_dir])
        finally:
            ev.classifier_predict_fn = predict_fn
        out["eval"] = {"wall": time.time() - t0, "agg": metrics["agg_metrics"]}
        out["eval_counts"] = read_counts(kernels)
        if keep:
            out["kept"]["plant"] = plant_head(torch, recorded)
        del recorded
        assert not any(out["eval_counts"].values()), out["eval_counts"]
        assert 0.0 <= metrics["agg_metrics"] <= 100.0, metrics
        out["peak"] = torch.cuda.max_memory_allocated() / 2 ** 30
        assert out["peak"] <= CLS_PEAK_GIB, out["peak"]
    finally:
        if not keep:
            shutil.rmtree(pth_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def opt_step_bytes(opt):
    """Weight bytes one decode step reads: every decoder weight but the
    position table (one row a step), the tied embedding once (the logits)."""
    return sum(p.numel() * p.element_size() for name, p in opt.decoder.named_parameters()
               if "embed_positions" not in name)


def blip2_opt_path(torch, kernels, out_dir):
    """Phase 21: the evaluate CLI's BLIP-2 OPT-2.7B captioning (random bf16
    weights, seed 42) at ``OPT_POINT``, through a recording wrapper of
    ``Blip2OPT.generate``; the tokens' validity and length; then batch 0's
    decode loop alone, twice, timed against its weight-read bound, its
    launches and device time under the profiler. Returns (counts,
    readings)."""
    from ecoflap_tpu_torch.cli import evaluate as ev
    from ecoflap_tpu_torch.models import blip2_opt
    from ecoflap_tpu_torch.models import generation as G
    from ecoflap_tpu_torch.models import opt as opt_mod

    calls = []
    generate = blip2_opt.Blip2OPT.generate

    def recording(self, images, prompt_ids, prompt_mask, gen=None, use_beam=True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate(self, images, prompt_ids, prompt_mask, gen, use_beam)
        torch.cuda.synchronize()
        calls.append((self, images, prompt_ids, prompt_mask, gen, toks,
                      time.perf_counter() - t0))
        return toks

    torch.cuda.reset_peak_memory_stats()
    blip2_opt.Blip2OPT.generate = recording
    try:
        reset_counts(kernels)
        t0 = time.time()
        metrics = ev.main(["--model", "blip2_opt", "--task", "captioning", "--model_scale",
                           "full", "--synthetic", "--seed", str(SEED), "--batch_size",
                           str(BATCH_SIZE), "--eval_batches", str(OPT_EVAL_BATCHES),
                           "--num_beams", str(OPT_POINT["num_beams"]), "--output_dir", out_dir])
        o = {"cli_wall": time.time() - t0}
        counts = read_counts(kernels)
    finally:
        blip2_opt.Blip2OPT.generate = generate
    assert not any(counts.values()), counts
    assert len(calls) == OPT_EVAL_BATCHES, len(calls)
    for k in ("Bleu_4", "ROUGE_L", "CIDEr", "agg_metrics"):
        assert metrics[k] is not None and math.isfinite(metrics[k]), (k, metrics)
    o["cider"] = metrics["CIDEr"]
    model, images, ids, mask, gen, toks0, _ = calls[0]
    cfg = model.cfg.opt
    lengths, finished = [], 0
    for *_, toks, _ in calls:
        assert toks.shape == (BATCH_SIZE, OPT_POINT["max_new_tokens"]), toks.shape
        assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "an id outside the vocab"
        for row in toks.cpu().tolist():
            n = row.index(cfg.eos_token_id) if cfg.eos_token_id in row else len(row)
            finished += n < len(row)
            assert set(row[n + 1:]) <= {cfg.pad_token_id}, "not pad after EOS"
            lengths.append(OPT_PROMPT_TOKENS + n)
    # HF's min_length: the prompt and the tokens before EOS
    assert min(lengths) >= OPT_POINT["min_length"], lengths
    o.update(shortest=min(lengths), finished=finished,
             generate_s=[c[-1] for c in calls])
    opt = model.opt_model
    with torch.inference_mode():
        x, m = model.decoder_inputs(model.encode_image(images), ids, mask)
        t = ids.shape[1]
        nb = gen.num_beams
        prefix, pmask, last, prompt = (G.expand_for_beams(v, nb) for v in (
            x[:, :-1], m[:, :-1], ids[:, -1], ids))

    def loop():
        with torch.inference_mode():
            cache = opt_mod.init_gen_cache(opt, prefix, pmask, gen.max_new_tokens)
            step = opt_mod.make_opt_step_fn(opt, prefix.shape[1], t - 1, gen.max_new_tokens)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = G.beam_generate(step, cache, BATCH_SIZE, gen, tok0=last, len_offset=t - 1,
                                  prompt_tokens=prompt, device=images.device)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

    first, _ = loop()
    again, loop_s = loop()
    assert torch.equal(first, again) and torch.equal(again, toks0), \
        "the decode loop gives other tokens than the CLI's batch 0"
    o["step_bytes"] = opt_step_bytes(opt)
    o["bound_ms"] = o["step_bytes"] / HBM_BYTES_PER_S * 1e3
    o["step_ms"] = loop_s / gen.max_new_tokens * 1e3
    launches, busy_ms = profile_launches(torch, loop)
    o["launches_per_step"] = launches / gen.max_new_tokens
    o["busy_ms_per_step"] = None if busy_ms is None else busy_ms / gen.max_new_tokens
    o["peak"] = torch.cuda.max_memory_allocated() / 2 ** 30
    assert o["peak"] <= OPT_PEAK_GIB, o["peak"]
    del calls, model, opt, x, prefix
    gc.collect()
    torch.cuda.empty_cache()
    return counts, o


def qformer_path(torch, kernels, out_dir):
    """Phase 22: the evaluate CLI's stage-1 Q-Former retrieval at tiny on
    the card and on the CPU with one model (its seeded init drawn on the
    CPU for both: the card's generator draws other numbers), the metrics
    equal; then ``--model_scale full``, which ends with the JAX CLI's
    message. Returns the readings."""
    from ecoflap_tpu_torch.cli import evaluate as ev
    from ecoflap_tpu_torch.models import blip2_qformer

    build = blip2_qformer.build_model

    def cpu_drawn(cfg, *, device=None, dtype=torch.float32, seed=0):
        return build(cfg, device="cpu", dtype=dtype, seed=seed).to(device)

    metrics = {}
    blip2_qformer.build_model = cpu_drawn
    try:
        for dev in ("cuda", "cpu"):
            reset_counts(kernels)
            m = ev.main(["--model", "blip2_qformer", "--task", "retrieval", "--device", dev,
                         "--seed", str(SEED), "--output_dir", out_dir])
            m.pop("eval_time_s")
            metrics[dev] = m
            if dev == "cuda":
                counts = read_counts(kernels)
    finally:
        blip2_qformer.build_model = build
    assert metrics["cuda"] == metrics["cpu"], metrics
    assert not any(counts.values()), counts
    try:
        ev.main(["--model", "blip2_qformer", "--task", "retrieval", "--model_scale", "full",
                 "--output_dir", out_dir])
        raise AssertionError("blip2_qformer retrieval ran at --model_scale full")
    except SystemExit as e:
        refusal = str(e)
    assert "only --model_scale tiny is configured" in refusal, refusal
    return {"metrics": metrics["cuda"], "refusal": refusal, "counts": counts}


def write_c4_jsonl(out_dir):
    """Phase 5's ``--calib`` files, C4-style (a ``{"text": ...}`` object a
    line): documents of 100-300 words of one hash token each, room for
    ``LLAMA_SAMPLES`` windows of ``LLAMA_SEQLEN`` and the one more that the
    CLI asks (some 133k tokens with the EOS that ends each document), and a
    file too short for them. Returns (path, short path)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    need = LLAMA_SAMPLES * LLAMA_SEQLEN + LLAMA_SEQLEN
    path = os.path.join(out_dir, "c4_calib.jsonl")
    with open(path, "w") as f:
        n = 0
        while n < need + LLAMA_SEQLEN:
            words = rng.integers(0, 20000, int(rng.integers(100, 300)))
            f.write(json.dumps({"text": " ".join(f"w{k}" for k in words)}) + "\n")
            n += len(words) + 1
    short = os.path.join(out_dir, "c4_short.jsonl")
    with open(short, "w") as f:
        f.write(json.dumps({"text": "a dog runs in the park"}) + "\n")
    return path, short


def run_recording_lm_batch(cli, kernels, argv):
    """``run_path`` with the LM calibration batch that the CLI builds kept.
    Returns (result, wall, counts, batch)."""
    from ecoflap_tpu_torch.data import calibration as cal

    kept, build = {}, cal.build_lm_calibration_batch

    def recording(*a, **kw):
        kept["batch"] = build(*a, **kw)
        return kept["batch"]

    cal.build_lm_calibration_batch = recording
    try:
        res, wall, counts = run_path(cli, kernels, argv)
    finally:
        cal.build_lm_calibration_batch = build
    return res, wall, counts, kept["batch"]


def check_jsonl_calibration(cli, argv, short, batch):
    """Phase 5's file checks, on the CPU with the CLI's parser and stream
    reader alone (no model): every calibration window of the run
    (``batch``) is a window of the file's token stream, and a file too short
    for the windows ends the run with the JAX CLI's message. Returns
    (stream tokens, the first window starts, the message)."""
    import numpy as np
    from numpy.lib.stride_tricks import sliding_window_view

    from ecoflap_tpu_torch.models import llama

    vocab = llama.config_for_scale("full").vocab_size
    parser = cli.build_parser()
    stream = cli._jsonl_stream(parser.parse_args(argv + ["--device", "cpu"]), vocab,
                               LLAMA_SEQLEN)
    windows = sliding_window_view(stream, LLAMA_SEQLEN)
    ids = batch["input_ids"].numpy()
    assert ids.shape == (LLAMA_SAMPLES, LLAMA_SEQLEN), ids.shape
    starts = []
    for row in ids:
        # candidates by the first 8 tokens, then the whole window
        cand = np.flatnonzero((windows[:, :8] == row[:8]).all(axis=1))
        hits = [int(c) for c in cand if np.array_equal(windows[c], row)]
        assert hits, "a calibration window is not in the file's stream"
        starts.append(hits[0])
    argv = list(argv)
    argv[argv.index("--calib") + 1] = short
    try:
        cli._jsonl_stream(parser.parse_args(argv + ["--device", "cpu"]), vocab, LLAMA_SEQLEN)
        raise AssertionError("a stream too short for the windows did not end the run")
    except SystemExit as e:
        message = str(e)
    need = LLAMA_SAMPLES * LLAMA_SEQLEN + LLAMA_SEQLEN
    assert message.endswith(f"need >= {need} for {LLAMA_SAMPLES} windows of "
                            f"{LLAMA_SEQLEN}"), message
    return len(stream), sorted(starts)[:4], message


def log_new_path(name, counts, info):
    log(f"{name} path checks pass: launches {counts}, finite scores in "
        f"[{info['scores'][0]:.4g}, {info['scores'][1]:.4g}], ratios <= "
        f"{info['max_ratio']:.4f}, global sparsity {info['sparsity']}, peak "
        f"{info['peak']:.2f} GiB"
        + (f" | .pth {info['pth_bytes']} bytes, export and write {info['pth_write_s']:.2f} s,"
           f" read back {info['pth_read_s']:.2f} s, every tensor equal"
           if "pth_bytes" in info else "")
        + (" | zero-shot: {prompts} prompts, classifier {build_s:.2f} s, {n} images in "
           "{eval_wall:.2f} s ({images_per_s:.1f} a second), accuracy {agg}".format(
               n=ZS_BATCHES * ZS_BATCH, **info["zero_shot"])
           if "zero_shot" in info else ""))


def reset_counts(kernels):
    for fn in kernels.values():
        fn.launches = 0


def read_counts(kernels):
    return {name: fn.launches for name, fn in kernels.items()}


def run_path(cli, kernels, argv):
    """One main-path run through the CLI with every count set to 0 just
    before and read just after; frees the model afterwards."""
    reset_counts(kernels)
    t0 = time.time()
    res = cli.main(argv)
    wall = time.time() - t0
    counts = read_counts(kernels)
    gc.collect()
    import torch

    torch.cuda.empty_cache()
    return res, wall, counts


def log_path(name, res, wall, counts):
    log(f"{name} path: {wall:.1f} s incl. model init | prune {res['wall_clock_s']} s | "
        + " | ".join(f"{k} {v:.2f}" for k, v in res["phase_times"].items())
        + f" | peak {res['peak_gib']:.2f} GiB | launches {counts}")


def check_scores_and_dict(read_flat_yaml, res, n_targets, cap, target, distinct=False):
    """MeZO scores (whole numbers of loss ulps, so some repeat) or first-order
    sums (``distinct``: every one differs) and the sparsity dict."""
    scores = res["leaf_scores"]
    vals = list(scores.values())
    assert len(vals) == n_targets, len(vals)
    assert all(math.isfinite(v) and v >= 0 for v in vals), "bad coarse scores"
    assert len(set(vals)) == n_targets if distinct else len(set(vals)) > 1, \
        "coarse scores not distinct"
    sd = read_flat_yaml(res["sparsity_dict"])
    assert len(sd) == n_targets and set(sd) == set(scores), "sparsity dict keys"
    assert max(sd.values()) <= cap + 1e-9, max(sd.values())
    assert abs(res["prunable_sparsity"] - target) <= 0.01, res["prunable_sparsity"]
    return vals, sd


def bf16_ulps(a, b, floor=2.0 ** -126):
    """|a - b| of two bf16 tensors in bf16 ulps of the larger magnitude, or
    of ``floor`` where both are smaller, per element (an ulp of x is
    2^(e - 8) for x = m 2^e, 0.5 <= m < 1)."""
    import torch

    af, bf = a.float(), b.float()
    big = torch.maximum(af.abs(), bf.abs()).clamp_min(floor)
    _, e = torch.frexp(big)
    return (af - bf).abs() / torch.ldexp(torch.ones_like(big), e - 8)


def plant_head(torch, recorded):
    """A classifier head planted on the images of a recorded evaluation
    (``(model, batch)`` per batch of the evaluate CLI's DeiT-B run, the
    model as the CLI loaded it from the ``.pth``): image i's planted class
    is its label for even i and the next class for odd i, so a top-1 of
    exactly 50.0 needs the checkpoint loaded, every image scored in order
    against its own label, and none dropped. The head's inputs come from the
    model's own forward with its head swapped for the identity; the weights
    are the least-squares fit (float64, centred) of ``PLANT_LOGIT`` at the
    planted class and 0 elsewhere, then checked through the model's own
    forward with the planted head: each image's planted class wins by
    ``PLANT_MARGIN``. Returns the head's weight and bias (CPU, float32),
    the top-1 they give and the least margin."""
    import numpy as np

    model = recorded[0][0]
    head = model.head
    d, ncls = head.weight.shape[1], head.weight.shape[0]
    dev, dtype = head.weight.device, head.weight.dtype
    images = [torch.from_numpy(np.asarray(b["image"])).to(dev, dtype) for _, b in recorded]
    labels = np.concatenate([np.asarray(b["label"]) for _, b in recorded])
    planted = labels.copy()
    planted[1::2] = (labels[1::2] + 1) % ncls

    def forward_with(w, b):
        model.head = torch.nn.Linear(w.shape[1], w.shape[0], device=dev, dtype=dtype)
        try:
            with torch.no_grad():
                model.head.weight.copy_(w)
                model.head.bias.copy_(b)
            with torch.inference_mode():
                return torch.cat([model(x) for x in images]).float()
        finally:
            model.head = head

    feats = forward_with(torch.eye(d), torch.zeros(d)).double().cpu()
    target = torch.zeros(len(labels), ncls, dtype=torch.float64)
    target[torch.arange(len(labels)), torch.from_numpy(planted)] = PLANT_LOGIT
    mean_f, mean_t = feats.mean(0), target.mean(0)
    w = (torch.linalg.pinv(feats - mean_f) @ (target - mean_t)).T
    b = mean_t - w @ mean_f
    w, b = w.float(), b.float()
    top2 = forward_with(w, b).cpu().topk(2, dim=-1)
    assert np.array_equal(top2.indices[:, 0].numpy(), planted), "the planted head misses"
    margin = (top2.values[:, 0] - top2.values[:, 1]).min().item()
    assert margin >= PLANT_MARGIN, margin
    return {"weight": w, "bias": b, "agg": 100.0 * float(np.mean(planted == labels)),
            "margin": margin}


class JoinedCollectives:
    """Stands in for ``parallel.mesh``'s ``all_gather_cat`` and
    ``all_reduce_`` while the tp ranks of one product run in turn on one
    card: the first pass records each rank's operand, the second returns
    what the collective gives every rank (the operands concatenated in rank
    order, or summed in rank order in their float32)."""

    def __init__(self):
        self.parts, self.joining = [], False

    def all_gather_cat(self, x, dim, group, size):
        import torch

        if not self.joining:
            self.parts.append(x.clone())
            return torch.cat([x] * size, dim=dim)
        return torch.cat(self.parts, dim=dim)

    def all_reduce_(self, x, group):
        if not self.joining:
            self.parts.append(x.clone())
            return x
        total = self.parts[0].clone()
        for part in self.parts[1:]:
            total += part
        return x.copy_(total)


def tp_linear(torch, path, w, x, tp):
    """Each tp rank's ``models/layers.linear(x, ...)`` with its shard of
    ``w``, placed by ``parallel.sharding.shard_params`` under LLaMA's name
    ``path``, the ranks run in turn and their collectives joined by
    ``JoinedCollectives``. Returns (the sharded dim, the ranks' outputs)."""
    from ecoflap_tpu_torch.models.layers import linear
    from ecoflap_tpu_torch.parallel import mesh as M
    from ecoflap_tpu_torch.parallel.sharding import shard_of, shard_params

    lins = []
    for rank in range(tp):
        root = mod = torch.nn.Module()
        *parents, leaf = path.split(".")
        for name in parents:
            mod.add_module(name, torch.nn.Module())
            mod = getattr(mod, name)
        mod.add_module(leaf, torch.nn.Linear(w.shape[1], w.shape[0], bias=False,
                                             device=w.device, dtype=w.dtype))
        root.requires_grad_(False)
        with torch.no_grad():
            root.get_submodule(path).weight.copy_(w)
        shard_params(root, M.Mesh(dp=1, tp=tp, dp_rank=0, tp_rank=rank))
        lins.append(root.get_submodule(path))
    joined = JoinedCollectives()
    saved = M.all_gather_cat, M.all_reduce_
    M.all_gather_cat, M.all_reduce_ = joined.all_gather_cat, joined.all_reduce_
    try:
        with torch.inference_mode():
            for lin in lins:
                linear(x, lin)
            joined.joining = True
            outs = [linear(x, lin) for lin in lins]
    finally:
        M.all_gather_cat, M.all_reduce_ = saved
    assert len(joined.parts) == tp, len(joined.parts)
    return shard_of(lins[0]).dim, outs


def tp_arithmetic(torch):
    """Phase 23 (c): ``models/layers.linear``'s tensor-parallel arithmetic
    on one card at LLaMA-7B shapes, bf16: ``tp_linear`` runs each rank's
    ``linear()`` in turn and joins the ranks as the collectives join them,
    q_proj (4096 -> 4096) column-parallel (each shard's product, gathered),
    down_proj (11008 -> 4096) row-parallel (each shard's float32 partial
    product, summed in float32, rounded once); every rank's output must be
    the same. Beside it the sum of bf16 partials, rounded tp times. Every
    result against the unsharded product in bf16 ulps of each output: the
    largest count (gated at 1) with an output smaller than
    ``TP_ULP_FLOOR`` x the product's RMS counted at that magnitude (below it
    the sum cancels, and two float32 orders of 11,008 products differ by
    more than its bf16 ulp: the unsharded product is no exacter there), the
    largest count at a floor of RMS / 256, and the share of outputs within
    1 ulp with no floor."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for name, (n_in, n_out) in TP_SHAPES.items():
        x = torch.randn(TP_TOKENS, n_in, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn(n_out, n_in, generator=g, device="cuda") * n_in ** -0.5
             ).to(torch.bfloat16)
        ref = F.linear(x, w)
        rms = ref.float().square().mean().sqrt().item()

        def ulps(y):
            return {"ulps": bf16_ulps(y, ref, TP_ULP_FLOOR * rms).max().item(),
                    "ulps_at_rms/256": bf16_ulps(y, ref, rms / 256).max().item(),
                    "share_1ulp_no_floor": (bf16_ulps(y, ref) <= 1).float().mean().item()}

        for tp in TP_SIZES:
            dim, outs = tp_linear(torch, TP_PATHS[name], w, x, tp)
            assert dim == (0 if name == "q_proj" else 1), (name, dim)
            assert all(torch.equal(o, outs[0]) for o in outs[1:]), (name, tp, "ranks differ")
            if name == "q_proj":  # column-parallel: the out dim split
                out[name, tp] = {"column": ulps(outs[0])}
            else:  # row-parallel: the in dim split
                xs, ws = x.chunk(tp, dim=-1), w.chunk(tp, dim=-1)
                b16 = F.linear(xs[0], ws[0])
                for a, b in zip(xs[1:], ws[1:]):
                    b16 = b16 + F.linear(a, b)
                out[name, tp] = {"row_f32_partials": ulps(outs[0]),
                                 "row_bf16_partials": ulps(b16)}
    torch.cuda.synchronize()
    return out


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_path(torch, kernels, kept):
    """Phase 23: the mesh on the card.
    (a) with torchrun's variables set for one rank, an NCCL group of world
    size 1, then phase 19's DeiT-B ECoFLaP run through the prune CLI with
    ``--mesh dp=1,tp=1``: its sparsity dict and ``.pth`` bit-identical to
    phase 19's, kernel 1 counted; the group destroyed.
    (b) ``python -m torch.distributed.run --nproc-per-node 1`` of the
    evaluate CLI with ``--mesh dp`` on that ``.pth`` with phase 19's
    planted head (``plant_head``): its top-1 exactly the planted 50.0.
    (c) ``tp_arithmetic``."""
    import torch.distributed as dist

    from ecoflap_tpu_torch.cli import prune as cli
    from ecoflap_tpu_torch.parallel.dist import destroy, init_distributed_mode

    out = {}
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    mesh_dir = os.path.join(kept["dir"], "mesh")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t0 = time.time()
        assert init_distributed_mode("cuda") and dist.get_backend() == "nccl"
        assert dist.get_world_size() == 1
        out["init_s"] = time.time() - t0
        res, wall, counts = run_path(cli, kernels, kept["argv"] + [
            "--mesh", "dp=1,tp=1", "--save_pruned_model", "--output_dir", mesh_dir])
        assert dist.is_initialized()  # the CLI leaves a group it did not start
        destroy()
        assert not dist.is_initialized()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["wall"], out["counts"] = wall, counts
    n = CLS_TARGETS["deit"]
    assert counts == {"perturb_inplace": 3 * n * (CLS_FIRST_STAGE // CLS_BATCH),
                      "perturb": 0, "flash_attention": 0, "flash_attention_bwd": 0}, counts
    with open(res["sparsity_dict"], "rb") as f, open(kept["sparsity_dict"], "rb") as g:
        assert f.read() == g.read(), "the --mesh dp=1,tp=1 sparsity dict differs"
    a, b = torch.load(res["pth"], weights_only=True), torch.load(kept["pth"], weights_only=True)
    assert sorted(a) == sorted(b)
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    assert not bad, bad[:3]
    out["pth_tensors"] = len(a)
    del res, a, b
    gc.collect()
    torch.cuda.empty_cache()
    # (b) the documented launch, one rank over NCCL, on the planted .pth
    t0 = time.time()
    plant = kept["plant"]
    state = torch.load(kept["pth"], weights_only=True)
    assert state["head.weight"].shape == plant["weight"].shape, state["head.weight"].shape
    state["head.weight"], state["head.bias"] = plant["weight"], plant["bias"]
    planted_pth = os.path.join(mesh_dir, "deit_planted_head.pth")
    os.makedirs(mesh_dir, exist_ok=True)
    torch.save(state, planted_pth)
    del state
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "1",
           "--master-addr", "127.0.0.1", "--master-port", str(free_port()),
           "-m", "ecoflap_tpu_torch.cli.evaluate", "--model", "deit", "--task",
           "classification", "--model_scale", "full", "--synthetic", "--checkpoint",
           planted_pth, "--batch_size", str(CLS_BATCH), "--mesh", "dp",
           "--output_dir", mesh_dir]
    env_run = {k: v for k, v in os.environ.items() if k not in env}
    env_run["PYTHONPATH"] = os.pathsep.join(
        [HERE] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else []))
    run = subprocess.run(cmd, cwd=HERE, env=env_run, capture_output=True, text=True,
                         timeout=TORCHRUN_TIMEOUT_S)
    out["torchrun_s"] = time.time() - t0
    assert run.returncode == 0, run.stderr[-3000:]
    metrics = json.loads([x for x in run.stdout.splitlines() if x.startswith("{")][-1])
    assert plant["agg"] == 50.0 and metrics["agg_metrics"] == plant["agg"], (metrics, plant)
    out["agg"], out["plant_margin"] = metrics["agg_metrics"], plant["margin"]
    # (c)
    t0 = time.time()
    out["tp"] = tp_arithmetic(torch)
    out["tp_s"] = time.time() - t0
    for (name, tp), r in out["tp"].items():
        key = "column" if name == "q_proj" else "row_f32_partials"
        assert r[key]["ulps"] <= 1.0, (name, tp, r)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after phase 3 (build, kernel checks, timing)")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from ecoflap_tpu_torch.ops import attention as A
    from ecoflap_tpu_torch.ops import build
    from ecoflap_tpu_torch.ops import perturb as P
    from ecoflap_tpu_torch.ops import sparsegpt_sweep as S

    kernels = {"perturb_inplace": P.perturb_inplace, "perturb": P.perturb,
               "flash_attention": A.flash_attention,
               "flash_attention_bwd": A.flash_attention_bwd}
    t_start = time.time()

    def phase_ended(n):
        log(f"-- phase {n} ended {time.time() - t_start:.1f} s into the run")

    # -- 1. device and build --------------------------------------------------
    smi = nvidia_smi_line()
    log(f"device: {smi} | torch {torch.__version__} | CUDA {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.time()
    log(f"card health: {card_health()}")
    built = build.build()
    log(f"kernel build: {time.time() - t0:.2f} s for {sorted(built)}")
    usage = {}
    for name, (lib, ptxas) in built.items():
        usage[name] = ptxas_usage(ptxas)
        for kernel, u in usage[name].items():
            log(f"  {name} {kernel} ({u['instances']} instance(s), the largest): "
                f"{u.get('registers')} registers, {u.get('stack_frame')} bytes stack "
                f"frame, {u.get('spill_stores')} bytes spill stores, "
                f"{u.get('spill_loads')} bytes spill loads")
        for line in ptxas.splitlines():
            if "Performance Loss" in line:  # e.g. wgmma serialised by ptxas
                log(f"  {name}: {line.strip()}")

    phase_ended(1)
    # -- 2. kernel vs plain ---------------------------------------------------
    worst_err, worst_ulp = 0.0, 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for shape in IN_PLACE_SHAPES:
            err, ulps = check_perturb(P, torch, shape, dtype)
            worst_err, worst_ulp = max(worst_err, err), max(worst_ulp, ulps)
    log(f"perturb_inplace vs plain: all {2 * len(IN_PLACE_SHAPES)} cases pass "
        f"(phase 5's LLaMA-7B shapes among them); "
        f"worst |w_kernel - w_plain| {worst_err:.3e} (scale 1e-3), "
        f"worst z {worst_ulp:.0f} ulp, Philox words (four per counter) bit-identical")
    view_err = max(check_perturb_view(P, torch, dtype)
                   for dtype in (torch.bfloat16, torch.float32))
    worst_err = max(worst_err, view_err)
    log(f"perturb_inplace and perturb on leaf[1] of a {RAGGED_LEAF} leaf (a view "
        f"off any 16-byte boundary), bf16 and f32: bit-identical to a contiguous "
        f"copy, other blocks untouched, worst |kernel - plain| {view_err:.3e}")
    oop_err = max(check_perturb_out_of_place(P, torch, shape, dtype)
                  for dtype in (torch.bfloat16, torch.float32)
                  for shape in OUT_OF_PLACE_SHAPES)
    log(f"perturb (out of place) vs plain: {2 * len(OUT_OF_PLACE_SHAPES)} cases "
        f"pass; bit-identical to the in-place kernel, input untouched, worst "
        f"|kernel - plain| {oop_err:.3e}")
    flash_err = {}
    for shape in FLASH_SHAPES:
        flash_err[shape] = check_flash(A, torch, shape)
        log(f"flash_attention vs plain {shape}: max |err| {flash_err[shape][0]:.4g}, "
            f"mean |err| {flash_err[shape][1]:.3e}, max err / max(1, |plain|) "
            f"{flash_err[shape][2]:.4g} (gates {FLASH_MAX_REL}, {FLASH_MEAN_ABS}); "
            f"strided inputs bit-identical; LSE output leaves the output's bits, "
            f"max |LSE err| {flash_err[shape][3]:.3e} (gate {FLASH_LSE_MAX_ABS})")
    bwd_err = {}
    for shape in FLASH_SHAPES:
        bwd_err[shape] = check_flash_bwd(A, torch, shape)
        max_abs, max_rel, rel_l2 = bwd_err[shape]
        log(f"flash_attention_bwd vs plain {shape}: max |err| {max_abs:.4g}, max err / "
            f"max(1, |plain|) {max_rel:.4g} (gate {FLASH_BWD_MAX_REL}), relative L2 "
            + ", ".join(f"{n} {v:.3e}" for n, v in rel_l2.items())
            + f" (gate {FLASH_BWD_REL_L2}); strided inputs and a second call "
            "bit-identical")
    check_flash_causal_and_refusals(A, torch)
    check_flash_bwd_causal_and_grad(A, torch)
    log("flash_attention: causal forward (rows <= r bit-identical when keys > r "
        "change) and backward (rows >= r exactly 0 when dO is 0 there); an input "
        "that requires grad is served through the kernels; ineligible shapes and "
        "float32 are refused, forward and backward")
    sweep = check_sparsegpt_sweep(S, torch)
    for label, (bad_q, bad_e, diff, outside, repeat) in sweep.items():
        log(f"sparsegpt_sweep vs _sweep_block, {label}: Q1 entries unlike {bad_q}, "
            f"Err1 entries unlike {bad_e} (largest |difference| {diff:.3e}); columns "
            f"outside the block untouched {outside}; a second launch the same {repeat}")
    unlike = {k: r for k, r in sweep.items() if r[:3] != (0, 0, 0.0) or not all(r[3:])}
    assert not unlike, f"the SparseGPT sweep kernel is not _sweep_block bit for bit: {unlike}"

    phase_ended(2)
    # -- 3. timing --------------------------------------------------------------
    timings = {}
    for shape in sorted(set(XL_SHAPES + [RAGGED] + LLAMA_SHAPES + CLIP_SHAPES
                            + CONVNEXT_SHAPES)):
        t = time_perturb(P, torch, shape)
        timings[shape] = t
        b, by = bound(t)
        log(f"perturb_inplace bf16 {shape[0]}x{shape[1]}: kernel {t['ms']:.4f} ms "
            f"(through the wrapper {t['wrapper_ms']:.4f} ms) | "
            f"bound {b:.4f} ms ({by}) | plain {t['plain_ms']:.3f} ms | "
            f"yardstick randn+mul_+add_ (three calls) "
            f"{t['three_call_yardstick_ms']:.4f} ms")
    weights = perturb_launch_weights()

    def avg(key):
        return weighted(timings, weights["perturb_inplace"], key)

    p_bound, p_by = bound({"bytes_bound_ms": avg("bytes_bound_ms"),
                           "ops_bound_ms": avg("ops_bound_ms")})
    old_ops_ms = avg("ops_bound_ms") * PERTURB_OPS_ONE_ELEMENT_PER_CALL / PERTURB_OPS_PER_ELEMENT
    for path in serial_cycle_paths():
        w = perturb_launch_weights([path])["perturb_inplace"]
        pb, pby = bound({k: weighted(timings, w, k)
                         for k in ("bytes_bound_ms", "ops_bound_ms")})
        log(f"perturb_inplace launch-weighted over the {path} serial cycle "
            f"({sum(w.values())} launches): kernel {weighted(timings, w, 'ms'):.4f} ms | "
            f"bound {pb:.4f} ms ({pby}) | share of bound "
            f"{pb / weighted(timings, w, 'ms'):.3f}")
    log(f"perturb_inplace launch-weighted over the serial cycles of phases 5, 14, 16, "
        f"17, 18, 19 and 20 ({sum(weights['perturb_inplace'].values())} launches): kernel "
        f"{avg('ms'):.4f} ms "
        f"(through the wrapper {avg('wrapper_ms'):.4f} ms) | bound "
        f"{p_bound:.4f} ms ({p_by}, {PERTURB_OPS_PER_ELEMENT} operations an element) | "
        f"share of bound {p_bound / avg('ms'):.3f} | the former count "
        f"({PERTURB_OPS_ONE_ELEMENT_PER_CALL} an element) would bound it at "
        f"{old_ops_ms:.4f} ms | plain {avg('plain_ms'):.3f} ms")
    from ecoflap_tpu_torch.pruning.mezo import perturb_seed

    host = time_perturb_host(P, torch, perturb_seed)
    log("perturb_inplace host side per launch (median of 200 calls into an idle "
        "queue): " + ", ".join(f"{k} {v:.2f} us" for k, v in host.items())
        + f" | device time at {XL_SHAPES[0][0]}x{XL_SHAPES[0][1]} "
        f"{timings[XL_SHAPES[0]]['ms'] * 1e3:.2f} us")
    oop_t = {s: time_perturb_out_of_place(P, torch, s) for s in XL_SHAPES}
    for t in oop_t.values():
        b, by = bound(t)
        log(f"perturb bf16 {t['shape'][0]}x{t['shape'][1]}: kernel {t['ms']:.4f} ms "
            f"(through the wrapper, with its output's allocation, {t['wrapper_ms']:.4f} "
            f"ms) | bound {b:.4f} ms ({by}) | plain {t['plain_ms']:.3f} ms")

    def oop_avg(key):
        return weighted(oop_t, weights["perturb"], key)

    o_bound, o_by = bound({k: oop_avg(k) for k in ("bytes_bound_ms", "ops_bound_ms")})
    log(f"perturb launch-weighted over phase 4's lane ensemble "
        f"({sum(weights['perturb'].values())} launches): kernel {oop_avg('ms'):.4f} ms "
        f"(through the wrapper {oop_avg('wrapper_ms'):.4f} ms) | bound {o_bound:.4f} ms "
        f"({o_by}) | share of bound {o_bound / oop_avg('ms'):.3f} | plain "
        f"{oop_avg('plain_ms'):.3f} ms")
    flash_t = time_flash(A, torch, FLASH_SHAPES[0])
    fb, fby = bound(flash_t)
    log(f"flash_attention {tuple(flash_t['shape'])}: kernel {flash_t['ms']:.4f} ms | "
        f"bound {fb:.4f} ms ({fby}; ops {flash_t['ops_bound_ms']:.4f}, bytes "
        f"{flash_t['bytes_bound_ms']:.4f}) | share of bound {fb / flash_t['ms']:.3f} | "
        f"plain {flash_t['plain_ms']:.3f} ms | "
        f"library scaled_dot_product_attention {flash_t['library_ms']:.4f} ms")
    gc.collect()
    torch.cuda.empty_cache()
    bwd_t = time_flash_bwd(A, torch, FLASH_SHAPES[0])
    bb, bby = bound(bwd_t)
    log(f"flash_attention_bwd {tuple(bwd_t['shape'])}: kernels {bwd_t['ms']:.4f} ms | "
        f"bound {bb:.4f} ms ({bby}; ops {bwd_t['ops_bound_ms']:.4f}, bytes "
        f"{bwd_t['bytes_bound_ms']:.4f}) | share of bound {bb / bwd_t['ms']:.3f} | "
        f"plain {bwd_t['plain_ms']:.3f} ms | library "
        f"scaled_dot_product_attention backward {bwd_t['library_ms']:.4f} ms "
        f"(forward + backward {bwd_t['library_fwd_bwd_ms']:.4f} ms)")
    gc.collect()
    torch.cuda.empty_cache()
    for rows in SWEEP_TIMING_ROWS:
        t = time_sparsegpt_sweep(S, torch, rows)
        b, by = bound(t)
        log(f"sparsegpt_sweep f32 one block of {rows}x128: kernel {t['ms'] * 1e3:.2f} us "
            f"(through the wrapper {t['wrapper_ms'] * 1e3:.2f} us) | bound {b * 1e3:.2f} us "
            f"({by}; ops {t['ops_bound_ms'] * 1e3:.2f}, bytes {t['bytes_bound_ms'] * 1e3:.2f})"
            f" | share of bound {b / t['ms']:.3f} | plain {t['plain_ms']:.3f} ms")
    if args.kernels_only:
        log(f"chip_smoke --kernels-only: {time.time() - t_start:.1f} s in all")
        return 0

    from ecoflap_tpu_torch.cli import prune as cli
    from ecoflap_tpu_torch.runners.runner import read_flat_yaml

    phase_ended(3)
    # -- 4. BLIP-2 path -----------------------------------------------------------
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    argv = ["--model", "blip2_t5", "--model_scale", "full", "--seed", str(SEED),
            "--pruning_method", "blipt5_wanda_pruner",
            "--vit_prune_spec", "39-0.5-1.0-1.0", "--t5_prune_spec", "24-0.5-1.0-1.0",
            "--sparsity_ratio_granularity", "block",
            "--score_method", "MEZO-GradOnly_sum", "--max_sparsity_per_layer", "0.6",
            "--num_data_first_stage", str(NUM_DATA_FIRST_STAGE),
            "--num_samples", str(NUM_SAMPLES), "--batch_size", str(BATCH_SIZE),
            "--calib", "synthetic", "--output_dir", out_dir]
    res, wall, blip_counts = run_path(cli, kernels, argv)
    log_path("BLIP-2", res, wall, blip_counts)
    shapes = xl_target_shapes()
    n_mb = NUM_DATA_FIRST_STAGE // BATCH_SIZE
    # the lane ensemble: per target and coarse microbatch one +eps and one
    # -eps copy by the out-of-place kernel, never the in-place one
    assert blip_counts["perturb"] == 2 * len(shapes) * n_mb == 2 * 588 * n_mb, blip_counts
    assert blip_counts["perturb_inplace"] == 0, blip_counts
    vals, sd = check_scores_and_dict(read_flat_yaml, res, 588, 0.6, 0.5)
    zeroth_dict = res["sparsity_dict"]
    log(f"BLIP-2 path checks pass: {blip_counts['perturb']} out-of-place perturb "
        f"launches, no in-place one, 588 finite scores in [{min(vals):.4g}, "
        f"{max(vals):.4g}], ratios <= {max(sd.values()):.4f}, global sparsity "
        f"{res['prunable_sparsity']}")
    del res

    phase_ended(4)
    # -- 5. LLaMA path, calibrated from a C4-style jsonl ---------------------------
    c4_path, c4_short = write_c4_jsonl(out_dir)
    argv = ["--model", "llama", "--model_scale", "full", "--seed", str(SEED),
            "--pruning_method", "llama_wanda_pruner",
            "--prune_spec", f"{LLAMA_LAYERS}-0.4-1.0-1.0",
            "--sparsity_ratio_granularity", "block",
            "--score_method", "MEZO-GradOnly_sum", "--max_sparsity_per_layer", "0.7",
            "--num_data_first_stage", str(LLAMA_FIRST_STAGE),
            "--num_samples", str(LLAMA_SAMPLES), "--batch_size", str(LLAMA_BATCH),
            "--seqlen", str(LLAMA_SEQLEN), "--calib", c4_path,
            "--output_dir", out_dir]
    res, wall, llama_counts, llama_batch = run_recording_lm_batch(cli, kernels, argv)
    log_path("LLaMA-7B", res, wall, llama_counts)
    n_targets = 7 * LLAMA_LAYERS
    llama_mb = LLAMA_FIRST_STAGE // LLAMA_BATCH
    # coarse: each target's +eps and -eps losses run blocks i..L-1, and the
    # suffix cache advances once through blocks 0..L-2; fine: per block, a
    # statistics pass and a re-forward, each in LLAMA_SAMPLES / LLAMA_BATCH
    # chunks
    want_flash = (2 * 7 * sum(LLAMA_LAYERS - i for i in range(LLAMA_LAYERS)) * llama_mb
                  + (LLAMA_LAYERS - 1) + 2 * LLAMA_LAYERS * (LLAMA_SAMPLES // LLAMA_BATCH))
    assert llama_counts["flash_attention"] == want_flash, (llama_counts, want_flash)
    assert llama_counts["perturb_inplace"] == 3 * n_targets * llama_mb, llama_counts
    assert llama_counts["perturb"] == 0, llama_counts
    vals, sd = check_scores_and_dict(read_flat_yaml, res, n_targets, 0.7, 0.6)
    assert sd.keys() == {f"model.layers.{i}.{n}.weight" for i in range(LLAMA_LAYERS)
                         for n in LLAMA_LINEARS}, "LLaMA sparsity dict keys"
    log(f"LLaMA-7B path checks pass: {llama_counts['flash_attention']} flash launches, "
        f"{llama_counts['perturb_inplace']} perturb launches, {n_targets} finite scores "
        f"in [{min(vals):.4g}, {max(vals):.4g}], ratios <= {max(sd.values()):.4f}, "
        f"global sparsity {res['prunable_sparsity']}")
    del res
    n_stream, starts, message = check_jsonl_calibration(cli, argv, c4_short, llama_batch)
    log(f"LLaMA-7B --calib jsonl (CPU, the CLI's parser and stream reader): the "
        f"{LLAMA_SAMPLES} windows of {LLAMA_SEQLEN} are windows of the file's stream of "
        f"{n_stream} tokens (first starts {starts}); a short file ends the run: {message!r}")

    phase_ended(5)
    # -- 6. LLaMA first-order path ---------------------------------------------------
    argv[argv.index("--calib") + 1] = "synthetic"
    argv[argv.index("--score_method") + 1] = "GradOnly_sum"
    argv[argv.index("--num_data_first_stage") + 1] = str(LLAMA_FO_FIRST_STAGE)
    res, wall, llama_fo_counts = run_path(cli, kernels, argv)
    log_path("LLaMA-7B first-order", res, wall, llama_fo_counts)
    fo_mb = LLAMA_FO_FIRST_STAGE // LLAMA_BATCH
    # coarse, per microbatch: the stack's forward and each block's recompute
    # under grad, and one backward per block; fine as in phase 5
    want_fo = {"flash_attention": 2 * LLAMA_LAYERS * fo_mb
               + 2 * LLAMA_LAYERS * (LLAMA_SAMPLES // LLAMA_BATCH),
               "flash_attention_bwd": LLAMA_LAYERS * fo_mb, "perturb_inplace": 0,
               "perturb": 0}
    assert llama_fo_counts == want_fo, (llama_fo_counts, want_fo)
    vals, sd = check_scores_and_dict(read_flat_yaml, res, n_targets, 0.7, 0.6,
                                     distinct=True)
    assert sd.keys() == {f"model.layers.{i}.{n}.weight" for i in range(LLAMA_LAYERS)
                         for n in LLAMA_LINEARS}, "LLaMA sparsity dict keys"
    log(f"LLaMA-7B first-order path checks pass: {llama_fo_counts['flash_attention']} "
        f"flash forward and {llama_fo_counts['flash_attention_bwd']} flash backward "
        f"launches, no perturb launch, {n_targets} distinct finite sums in "
        f"[{min(vals):.4g}, {max(vals):.4g}], ratios <= {max(sd.values()):.4f}, global "
        f"sparsity {res['prunable_sparsity']}, peak {res['peak_gib']:.2f} GiB")
    del res

    phase_ended(6)
    # -- 7. BLIP-2 first-order path --------------------------------------------------
    argv = ["--model", "blip2_t5", "--model_scale", "full", "--seed", str(SEED),
            "--pruning_method", "blipt5_wanda_pruner",
            "--vit_prune_spec", "39-0.5-1.0-1.0", "--t5_prune_spec", "24-0.5-1.0-1.0",
            "--sparsity_ratio_granularity", "block",
            "--score_method", "GradMagAbs_sum", "--max_sparsity_per_layer", "0.6",
            "--num_data_first_stage", str(BLIP2_FO_FIRST_STAGE),
            "--num_samples", str(NUM_SAMPLES), "--batch_size", str(BATCH_SIZE),
            "--calib", "synthetic", "--output_dir", out_dir]
    res, wall, blip_fo_counts = run_path(cli, kernels, argv)
    log_path("BLIP-2 first-order", res, wall, blip_fo_counts)
    assert not any(blip_fo_counts.values()), blip_fo_counts
    vals, sd = check_scores_and_dict(read_flat_yaml, res, 588, 0.6, 0.5, distinct=True)
    log(f"BLIP-2 first-order path checks pass: no kernel launch, 588 distinct finite "
        f"sums in [{min(vals):.4g}, {max(vals):.4g}], ratios <= {max(sd.values()):.4f}, "
        f"global sparsity {res['prunable_sparsity']}, peak {res['peak_gib']:.2f} GiB")
    del res

    phase_ended(7)
    # -- 8. BLIP-2 SparseGPT path from phase 4's dict -------------------------------
    argv = ["--model", "blip2_t5", "--model_scale", "full", "--seed", str(SEED),
            "--pruning_method", "blipt5_sparsegpt_pruner",
            "--vit_prune_spec", "39-0.5-1.0-1.0", "--t5_prune_spec", "24-0.5-1.0-1.0",
            "--num_samples", str(NUM_SAMPLES), "--batch_size", str(BATCH_SIZE),
            "--sparsity_dict", zeroth_dict, "--calib", "synthetic",
            "--output_dir", out_dir]
    sweeps = S.sparsegpt_sweep.launches
    res, wall, sgpt_counts = run_path(cli, kernels, argv)
    sweeps = S.sparsegpt_sweep.launches - sweeps
    log_path("BLIP-2 SparseGPT", res, wall, sgpt_counts)
    assert not any(sgpt_counts.values()), sgpt_counts
    want_sweeps = sweep_blocks(res["model"])
    counted = {k: v for k, v in res["phase_times"].items() if k.endswith("_sweep_kernels_n")}
    assert sweeps == sum(counted.values()) == sum(want_sweeps.values()), \
        (sweeps, counted, want_sweeps)
    block_err = check_sparsegpt_prune(torch, res, read_flat_yaml(zeroth_dict))
    split = sparsegpt_split(res["phase_times"])
    log(f"BLIP-2 SparseGPT path checks pass: no perturbation or flash launch, "
        f"{sweeps} sweep kernel launches, one a column block of each weight group ("
        + ", ".join(f"{k} {v}" for k, v in want_sweeps.items()) + "), every weight finite, "
        f"every block's zero share within {block_err:.4f} of its ratio (gate "
        f"{SPARSEGPT_BLOCK_TOL}), global sparsity {res['prunable_sparsity']}, peak "
        f"{res['peak_gib']:.2f} GiB | fine wall split: " + "; ".join(
            f"{stack} {parts['s']:.2f} s = collect {parts['collect_s']:.2f} + "
            f"prepare_hinv {parts['prepare_hinv_s']:.2f} + sweep {parts['sweep_s']:.2f}"
            f" + other prune {parts['prune_s'] - parts['prepare_hinv_s'] - parts['sweep_s']:.2f}"
            f" + reforward {parts['reforward_s']:.2f}"
            for stack, parts in split.items()))
    del res
    gc.collect()
    torch.cuda.empty_cache()
    sd = read_flat_yaml(zeroth_dict)
    vit_ratio = sd["visual_encoder.blocks.0.attn.qkv.weight"]
    for local, r in vit_block_sparsegpt(torch, vit_ratio).items():
        log(f"ViT-g block 0 {local} at phase 8's init, ratio {vit_ratio:.4f}, SparseGPT "
            f"card vs CPU from one f32 H (on the card through {r['kernel_launches']} sweep "
            f"kernel launches, bit for bit the prune through _sweep_block, alone and in 2 "
            f"lanes): H eigenvalue ratio {r['eig_ratio']:.3e}, "
            f"undamped Cholesky fails (card, CPU) {r['undamped_cholesky_fails']}, mask "
            f"mismatch share {r['mask_share']:.3e}, weights relative L2 {r['rel_l2']:.3e} | "
            f"reconstruction error card {r['recon_card']:.6f}, CPU {r['recon_cpu']:.6f} "
            f"(gate {SPARSEGPT_XL_RECON_RTOL} relative), mask alone {r['recon_mask_only']:.6f}")

    phase_ended(8)
    # -- 9. card vs CPU: the lane ensemble against the serial path, the global pruners
    from ecoflap_tpu_torch.core.device import exact_float32_matmuls

    exact_float32_matmuls()  # float32 on the card as on the CPU: TF32 off
    lerr, serr = small_reference_check(torch)
    log(f"tiny BLIP-2 card vs CPU: loss rel err {lerr:.2e}, MeZO score err beyond "
        f"rtol 1e-3 {serr:.2e}")
    logits_rel, loss_rel, grad_rel = small_llama_check(torch)
    log(f"small LLaMA bf16 card (flash kernels) vs f32 CPU: logits relative L2 "
        f"{logits_rel:.3e} (gate {LLAMA_LOGITS_REL}), per-sample loss rel err "
        f"{loss_rel:.3e} (gate {LLAMA_LOSS_RTOL}), GradOnly sums rel err "
        f"{grad_rel:.3e} (gate {LLAMA_GRAD_SUMS_RTOL}), bit-identical over two "
        f"card runs")
    small_blip2 = small_blip2_setup(torch)
    for what, (err, n) in ensemble_vs_serial_checks(torch, P, small_blip2).items():
        log(f"{what} on the card, f32: lane ensemble vs serial cycle, the same seeds, "
            f"{n} targets: worst score difference beyond rtol {ENSEMBLE_RTOL} is {err:.3e} "
            f"(gate {ENSEMBLE_ATOL})")
    lo, hi, n = shared_mode_check(P, small_blip2)
    del small_blip2
    log(f"small BLIP-2 on the card, noise_mode shared, lane ensemble: {n} finite "
        f"distinct scores in [{lo:.4g}, {hi:.4g}]")
    mask_share, rel_l2 = small_sparsegpt_check(torch)
    log(f"tiny BLIP-2 SparseGPT card vs CPU, f32: mask mismatch share {mask_share:.2e} "
        f"(gate {SPARSEGPT_MASK_SHARE}), pruned weights relative L2 {rel_l2:.3e} "
        f"(gate {SPARSEGPT_REL_L2})")
    g = global_pruner_checks(torch, P, out_dir)
    log(f"tiny global pruners card vs CPU, f32: magnitude (3 steps) "
        f"{g['magnitude_flips']} mask entries differ; |W| |G| one step: flips at most "
        f"{g['gradmagabs_one_step_flip_distance']:.2e} from the threshold (gate "
        f"{GLOBAL_NEAR_TIE}), 3 steps: {g['gradmagabs_flip_share']:.2e} of the entries "
        f"differ (gate {GLOBAL_GRAD_MASK_SHARE}); MeZO (one seed, one step): "
        f"whole-tensor masks equal, {g['mezo_kernel1_launches']} in-place perturb "
        f"launches on the card, {g['mezo_wall_s_both_devices']:.1f} s for both devices; "
        f"--coarse_only Real-GradMagAbs_sum layer --prune_per_model from one --ckpt: "
        f"{g['real_coarse_only_flipped_entries']:.0f} entries flipped (gate "
        f"{REAL_F32_FLIP_SHARE} of all); SparseGPT --hessian_bf16: first block masks "
        f"equal, relative L2 {g['sparsegpt_bf16'][2]:.3e} (gate "
        f"{SPARSEGPT_BF16_FIRST_REL_L2}), whole model mask mismatch share "
        f"{g['sparsegpt_bf16'][0]:.2e} (gate {SPARSEGPT_BF16_MASK_SHARE}), relative L2 "
        f"{g['sparsegpt_bf16'][1]:.3e}; "
        f"llama_magnitude_pruner {g['llama_magnitude_flips']} entries differ")
    real_worst, real_launches = small_llama_real_check(torch, A)
    log(f"small LLaMA Real-GradMagAbs_sum coarse stage, bf16 card (flash kernels: "
        f"{real_launches[0]} forward, {real_launches[1]} backward launches) vs f32 CPU: "
        f"worst per-target zero-share difference {real_worst:.3e} (gate "
        f"{REAL_BF16_SHARE_TOL})")
    finished = tiny_blip2_generate_check(torch)
    log("tiny BLIP-2 generate card vs CPU, f32: identical tokens in all "
        f"{len(finished)} cases (rows finished of 8: "
        + ", ".join(f"{k} {v}" for k, v in finished.items()) + ")")
    bf = tiny_blip2_bf16_check(torch)
    log(f"tiny BLIP-2 bf16 (EOS row +{EOS_BOOST}) decode step card vs CPU over "
        f"{CAPTION_POINT['max_new_tokens']} teacher-forced steps: logits rel L2 "
        f"{bf['step_rel_l2']:.3e} (gate {BF16_STEP_LOGITS_REL}), {bf['off_grid']:.3f} of "
        "them no bf16 value (float32 sums); card generate, ids in the vocab and pad "
        "after EOS (rows finished, rows equal to the CPU's, of 8): "
        + ", ".join(f"{k} {f}, {e}" for k, (f, e) in bf["cases"].items()))
    ppl_rel, ppl_launches = small_llama_ppl_check(torch, A)
    log(f"small LLaMA perplexity bf16 card ({ppl_launches} flash launches) vs f32 CPU: "
        f"log-ppl rel err {ppl_rel:.3e} (gate {LLAMA_LOSS_RTOL})")
    nf = new_family_checks(torch, P, out_dir)
    log(f"tiny standalone T5 card vs CPU, f32, from one --ckpt: zeroth-order "
        f"(t5_wanda_pruner, block, eps {ENSEMBLE_EPS}; kernel 1 on the card) dicts within "
        f"rtol {NEW_FAMILY_DICT_RTOL}, mask flip share "
        f"{nf['t5_wanda_pruner_mask_flip_share']:.2e}; t5_sparsegpt_pruner on random ids "
        f"mask flip share {nf['t5_sparsegpt_pruner_mask_flip_share']:.2e} (gates "
        f"{NEW_FAMILY_MASK_SHARE}) | tiny CLIP contrastive loss rel L2 "
        f"{nf['clip_loss_rel_l2']:.3e}, zero-shot logits {nf['clip_zero_shot_rel_l2']:.3e}; "
        f"tiny EVA-CLIP {nf['eva_clip_loss_rel_l2']:.3e}, "
        f"{nf['eva_clip_zero_shot_rel_l2']:.3e}; tiny T5 MMLU first-token logits "
        f"{nf['mmlu_logits_rel_l2']:.3e} (gates {NEW_FAMILY_REL_L2})")
    b1 = blip1_tiny_checks(torch, P, out_dir)
    log(f"tiny BLIP-1 card vs CPU, f32, kernels x{BLIP1_TINY_KERNEL_SCALE}: per-sample loss "
        f"rel L2 (gate {NEW_FAMILY_REL_L2}) and the UPop launcher from one --ckpt (eps "
        f"{BLIP1_TINY_EPS}, kernel 1 on the card; dicts within rtol {NEW_FAMILY_DICT_RTOL}, "
        f"mask flips gate {NEW_FAMILY_MASK_SHARE}): " + "; ".join(
            f"{h} loss {r['loss_rel_l2']:.3e}, flips {r['mask_flip_share']:.2e}, "
            f"{r['launches']} kernel-1 launches, sparsity {r['sparsity']:.4f}, both "
            f"launcher runs {r['wall']:.1f} s"
            for h, r in b1.items()))
    s12 = slice12_tiny_checks(torch)
    log(f"tiny DeiT / ConvNeXt (layer scales U{CONVNEXT_GAMMA}) card vs CPU, f32: logits rel "
        f"L2 {s12['deit_logits_rel_l2']:.3e} / {s12['convnext_logits_rel_l2']:.3e}, CE loss "
        f"{s12['deit_loss_rel_l2']:.3e} / {s12['convnext_loss_rel_l2']:.3e} (gates "
        f"{NEW_FAMILY_REL_L2}) | tiny BLIP-2 OPT (kernels x{OPT_TINY_KERNEL_SCALE}, EOS "
        f"+{OPT_TINY_EOS_BOOST}) tokens identical card vs CPU, greedy and beam 5 (rows "
        f"finished of 6: {s12['blip2_opt_greedy_finished']}, {s12['blip2_opt_beam5_finished']})"
        f" | tiny Q-Former retrieval: ITC sims rel L2 {s12['qformer_sims_rel_l2']:.3e}, ITM "
        f"logits {s12['qformer_itm_rel_l2']:.3e} (gates {NEW_FAMILY_REL_L2})")
    cli_flips, block0 = nf["t5_sparsegpt_cli_batch"]
    log(f"tiny T5 t5_sparsegpt_pruner on the CLI's own batch, card vs CPU, f32: mask flip "
        f"share {cli_flips:.4e} (a reading); encoder block 0 from one H per linear: " + "; ".join(
            f"{k} H rank {r['rank']} of {r['size']}, eigenvalue ratio {r['eig_ratio']:.2e}, "
            f"mask flips f32 {r['mask_share']:.4f}, f64 {r['mask_share_f64']:.4f} (gate "
            f"{NEW_FAMILY_MASK_SHARE}), objective card {r['recon_card']:.6f} CPU "
            f"{r['recon_cpu']:.6f} (gate {SPARSEGPT_XL_RECON_RTOL} relative)"
            for k, r in block0.items()))
    gc.collect()
    torch.cuda.empty_cache()

    phase_ended(9)
    # -- 10. BLIP-2 global magnitude path, and its .pth -----------------------------
    pth_dir = tempfile.mkdtemp(prefix="chip_smoke_pth_")
    try:
        argv = global_xl_argv("blipt5_global_mag_pruner", pth_dir) + ["--save_pruned_model"]
        res, wall, mag_counts = run_path(cli, kernels, argv)
        log_path("BLIP-2 global magnitude", res, wall, mag_counts)
        assert not any(mag_counts.values()), mag_counts
        shares = check_global_prune(torch, res, GLOBAL_MAG_SPARSITY)
        size, read_s = pth_round_trip(torch, res)
        log(f"BLIP-2 global magnitude path checks pass: no kernel launch, every weight "
            f"finite, prunable sparsity {res['prunable_sparsity']} in {GLOBAL_MAG_SPARSITY}, "
            f"zero share per stack " + ", ".join(f"{k} {v:.5f}" for k, v in shares.items())
            + f", peak {res['peak_gib']:.2f} GiB | .pth {size} bytes, export and write "
            f"{res['pth_write_s']:.2f} s, read into a fresh XL model {read_s:.2f} s, every "
            f"tensor equal")
        del res
    finally:
        shutil.rmtree(pth_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    phase_ended(10)
    # -- 11. BLIP-2 global |W| |G| path --------------------------------------------
    argv = global_xl_argv("blipt5_global_gradmagabs_pruner", out_dir)
    res, wall, grad_counts = run_path(cli, kernels, argv)
    log_path("BLIP-2 global |W| |G|", res, wall, grad_counts)
    assert not any(grad_counts.values()), grad_counts
    stats = res["pruner"].importance_stats
    assert len(stats) == GLOBAL_ITERATIONS and not any(st["nonfinite"] for st in stats), stats
    shares = check_global_prune(torch, res, GLOBAL_GRAD_SPARSITY)
    fwd_ms = full_loss_forward_ms(torch, res)
    scored_mb = GLOBAL_SCORED // BATCH_SIZE
    mezo_est = GLOBAL_ITERATIONS * 2 * 588 * scored_mb * fwd_ms / 1e3
    log(f"BLIP-2 global |W| |G| path checks pass: no kernel launch, finite importances "
        f"({stats[0]['bytes']} bytes of float32 importance a step), prunable sparsity "
        f"{res['prunable_sparsity']} in {GLOBAL_GRAD_SPARSITY}, zero share per stack "
        + ", ".join(f"{k} {v:.5f}" for k, v in shares.items())
        + f", peak {res['peak_gib']:.2f} GiB | one full-loss forward at {BATCH_SIZE} "
        f"samples {fwd_ms:.2f} ms, so the global MeZO baseline (no suffix plans: 2 x 588 "
        f"x {scored_mb} of them a step, {GLOBAL_ITERATIONS} steps) would spend about "
        f"{mezo_est:.0f} s in forwards (an estimate)")
    del res
    gc.collect()
    torch.cuda.empty_cache()

    phase_ended(11)
    # -- 12. BLIP-2 FlanT5-XL evaluation: synthetic VQA, then generate's checks --
    from ecoflap_tpu_torch.cli import evaluate as ev
    from ecoflap_tpu_torch.models import blip2 as blip2_mod

    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    # keep a copy of the tokens each of the CLI's batches generates: the
    # CLI itself only returns the scores of their decoded texts
    cli_tokens, generate = [], blip2_mod.Blip2T5.generate

    def recording_generate(self, *a, **kw):
        toks = generate(self, *a, **kw)
        cli_tokens.append(toks.clone())
        return toks

    blip2_mod.Blip2T5.generate = recording_generate
    t0 = time.time()
    try:
        vqa = ev.main(["--model", "blip2_t5", "--task", "vqa", "--model_scale", "full",
                       "--synthetic", "--batch_size", str(BATCH_SIZE), "--eval_batches",
                       str(EVAL_BATCHES), "--num_beams", str(VQA_POINT["num_beams"]),
                       "--max_new_tokens", str(VQA_POINT["max_new_tokens"]),
                       "--length_penalty", str(VQA_POINT["length_penalty"]),
                       "--seed", str(SEED), "--output_dir", out_dir])
    finally:
        blip2_mod.Blip2T5.generate = generate
    vqa_wall = time.time() - t0
    gc.collect()
    torch.cuda.empty_cache()
    # the tokens the CLI scored: one (8, 10) array a batch, ids in the vocab,
    # only pad after a row's first EOS
    assert [tuple(t.shape) for t in cli_tokens] == \
        [(BATCH_SIZE, VQA_POINT["max_new_tokens"])] * EVAL_BATCHES, cli_tokens
    cli_finished = [check_tokens(torch, t, blip2_mod.blip2_flant5xl().t5.vocab_size,
                                 f"XL VQA CLI batch {i}") for i, t in enumerate(cli_tokens)]
    x = eval_xl_checks(torch, cli_tokens[0])
    eval_counts = read_counts(kernels)
    eval_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # BLIP-2's attention is naive: no kernel of the port on this path
    assert not any(eval_counts.values()), eval_counts
    assert len(vqa["batch_walls_s"]) == EVAL_BATCHES and vqa["steady_qps"] > 0, vqa
    log(f"BLIP-2 FlanT5-XL eval path (VQA, {EVAL_BATCHES} batches of {BATCH_SIZE}, beam "
        f"{VQA_POINT['num_beams']}, {VQA_POINT['max_new_tokens']} tokens, lp "
        f"{VQA_POINT['length_penalty']}): {vqa_wall:.1f} s incl. model init | eval "
        f"{vqa['eval_time_s']} s | batch walls {vqa['batch_walls_s']} s | steady_qps "
        f"{vqa['steady_qps']} | agg_metrics {vqa['agg_metrics']} | peak {eval_peak:.2f} GiB "
        f"| launches {eval_counts}")
    busy = x["vqa_busy_ms_per_step"]
    log(f"BLIP-2 FlanT5-XL decode loop, batch 0 (40 beams): {x['vqa_step_ms']:.3f} ms a "
        f"step at the VQA point | bound {x['bound_ms']:.3f} ms ({x['step_bytes']} weight "
        f"bytes a step at {HBM_BYTES_PER_S:.3g} B/s) | {x['vqa_launches_per_step']:.0f} CUDA "
        f"launches a step | device busy "
        + ("not measured" if busy is None else f"{busy:.3f} ms a step (profiled)")
        + f" | captioning point (beam {CAPTION_POINT['num_beams']}, "
        f"{CAPTION_POINT['max_new_tokens']} tokens, lp {CAPTION_POINT['length_penalty']}): "
        f"{x['caption_step_ms']:.3f} ms a step | rows finished: VQA {x['vqa_finished']}, "
        f"captioning {x['caption_finished']} of {BATCH_SIZE}, the CLI's batches "
        f"{cli_finished}; ids in the vocab and pad after EOS in the CLI's {EVAL_BATCHES} "
        f"batches and in these; batch 0 the same in the CLI, through generate on the "
        f"rebuilt model and twice through the loop")
    gc.collect()
    torch.cuda.empty_cache()

    phase_ended(12)
    # -- 13. LLaMA-7B WikiText perplexity -----------------------------------------
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    t0 = time.time()
    ppl = ev.main(["--model", "llama", "--task", "wikitext_ppl", "--model_scale", "full",
                   "--synthetic", "--batch_size", str(BATCH_SIZE), "--seqlen",
                   str(LLAMA_SEQLEN), "--seed", str(SEED), "--output_dir", out_dir])
    ppl_wall = time.time() - t0
    gc.collect()
    torch.cuda.empty_cache()
    # the CLI's stream is one window, so one forward at batch 1; then 64
    # windows through the same task and Runner at batch 8, the shape phase
    # 2 holds the kernel at and times
    long_ppl, long_wall = eval_ppl_stream(torch, out_dir)
    ppl_counts = read_counts(kernels)
    ppl_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gc.collect()
    torch.cuda.empty_cache()
    # one forward per batch of windows, one flash forward launch per block
    forwards = -(-(EVAL_STREAM_TOKENS // LLAMA_SEQLEN) // BATCH_SIZE)
    long_forwards = -(-EVAL_PPL_WINDOWS // BATCH_SIZE)
    want_ppl = {"flash_attention": LLAMA_LAYERS * (forwards + long_forwards),
                "flash_attention_bwd": 0, "perturb_inplace": 0, "perturb": 0}
    assert ppl_counts == want_ppl, (ppl_counts, want_ppl)
    assert math.isfinite(ppl["ppl"]) and ppl["ppl"] > 1, ppl
    assert math.isfinite(long_ppl["ppl"]) and long_ppl["ppl"] > 1, long_ppl
    log(f"LLaMA-7B WikiText perplexity path: the CLI ({EVAL_STREAM_TOKENS} tokens, "
        f"windows of {LLAMA_SEQLEN}, {forwards} forward at batch 1): {ppl_wall:.1f} s incl. "
        f"model init | eval {ppl['eval_time_s']} s | ppl {ppl['ppl']:.6g}; then "
        f"{EVAL_PPL_WINDOWS} windows ({long_forwards} forwards at batch {BATCH_SIZE}): "
        f"{long_wall:.1f} s incl. model init | eval {long_ppl['eval_time_s']} s | ppl "
        f"{long_ppl['ppl']:.6g}; peak {ppl_peak:.2f} GiB | launches {ppl_counts}")

    gc.collect()
    torch.cuda.empty_cache()

    phase_ended(13)
    # -- 14. standalone FlanT5-XL, through --cfg-path ---------------------------------
    t5_counts, t5_info = t5_xl_path(torch, cli, kernels, out_dir, read_flat_yaml)
    log_new_path("FlanT5-XL standalone (ECoFLaP zeroth-order + Wanda, --cfg-path "
                 f"{T5_CFG_PATH})", t5_counts, t5_info)

    phase_ended(14)
    # -- 15. FlanT5-XL MMLU -----------------------------------------------------------
    mmlu_counts, mm = mmlu_xl(torch, kernels, out_dir)
    log(f"FlanT5-XL MMLU: the CLI (synthetic, college_physics, 8 questions) "
        f"{mm['cli_wall']:.1f} s incl. model init, {mm['cli']}; then {mm['prompts']} "
        f"prompts ({MMLU_SHOTS} shots, 57 subjects x {MMLU_TEST_PER_SUBJECT}; "
        f"{mm['tokens'][0]}-{mm['tokens'][2]} tokens, mean {mm['tokens'][1]:.1f}, none cut "
        f"at {MMLU_MAX_TOKENS}, a batch padded to its longest, mean {mm['padded']:.1f}) through "
        f"MMLUTask and Runner.evaluate: {mm['wall']:.2f} s, {mm['prompts_per_s']:.1f} "
        f"prompts a second, batch walls {min(mm['walls']):.4f}-{max(mm['walls']):.4f} s, "
        f"agg_metrics {mm['agg']}, predictions A-D {mm['pred_counts']}, the same over two "
        f"passes, finite logits; peak {mm['peak']:.2f} GiB | launches {mmlu_counts}")

    phase_ended(15)
    # -- 16. EVA-CLIP-g, through --cfg-path, and its zero-shot classifier -----------
    eva_counts, eva_info = eva_clip_path(torch, cli, kernels, out_dir, read_flat_yaml)
    log_new_path(f"EVA-CLIP-g (--cfg-path {EVA_CFG_PATH})", eva_counts, eva_info)

    phase_ended(16)
    # -- 17. CLIP ViT-B/16, the CoOp launcher's second loop ---------------------------
    clip_counts, clip_info = clip_path(torch, cli, kernels, out_dir, read_flat_yaml)
    log_new_path("CLIP ViT-B/16 (scripts/coop/ecoflap_wanda.sh)", clip_counts, clip_info)

    phase_ended(17)
    # -- 18. BLIP-1 caption, the UPop run: prune, fine-tune, .pth, captioning -------
    blip1_counts, blip1_eval_counts, b = blip1_path(torch, kernels, out_dir)
    ph = b["phases"]
    log(f"BLIP-1 caption (blip_base, 384 px, bf16; cli/upop.py --head caption, "
        f"{BLIP1_SAMPLES} samples, p 0.5): {b['wall']:.1f} s incl. model init | prune "
        f"{b['prune']:.2f} s: coarse {ph['coarse_s']:.2f} s, fine "
        + ", ".join(f"{k[len('fine_'):-2]} {v:.2f} s" for k, v in ph.items()
                    if k.startswith("fine_"))
        + f" | fine-tune {b['ft_s']:.3f} s a step, loss {b['ft_losses'][0]:.6f} -> "
        f"{b['ft_losses'][1]:.6f} | peak {b['peak']:.2f} GiB | launches {blip1_counts} | "
        f"{smi}")
    log(f"BLIP-1 caption path checks pass: {blip1_counts['perturb_inplace']} kernel-1 "
        f"launches (3 x {BLIP1_TARGETS} x {BLIP1_SAMPLES // BLIP1_MICROBATCH}), finite "
        f"scores in [{b['scores'][0]:.4g}, {b['scores'][1]:.4g}] under the reference keys, "
        f"block ratios <= {b['max_ratio']:.4f}, global sparsity {b['sparsity']:.4f}; "
        f"{BLIP1_FT_STEPS} masked AdamW steps kept every pruned entry 0 and changed "
        f"{b['changed_share']:.4f} of the unpruned weights (bf16: an update of about "
        f"1e-5 rounds away on most) | .pth {b['pth_bytes']} bytes, {b['pth_keys']} keys, "
        f"read back and into a fresh model {b['pth_read_s']:.2f} s, every tensor equal")
    log(f"BLIP-1 captioning from the .pth (evaluate CLI, {BLIP1_EVAL_BATCHES} batches of "
        f"{BLIP1_MICROBATCH}, beam {BLIP1_CAPTION_POINT['num_beams']}, "
        f"{BLIP1_CAPTION_POINT['max_new_tokens']} tokens): {b['eval_wall']:.1f} s incl. "
        f"model load | eval {b['eval_s']} s | generate walls "
        + ", ".join(f"{w:.3f}" for w in b["generate_s"])
        + f" s, {b['token_ms']:.2f} ms a token (the best batch over its "
        f"{BLIP1_CAPTION_POINT['max_new_tokens']} steps, image encode and prefill "
        f"included) | peak {b['eval_peak']:.2f} GiB | launches {blip1_eval_counts} | {smi}")

    phase_ended(18)
    # -- 19-20. DeiT-B and ConvNeXt-T: prune, ECoFLaP, the .pth, classification
    cls = {}
    for n, kind in ((19, "deit"), (20, "convnext")):
        t0 = time.time()
        cls[kind] = classifier_path(torch, kernels, out_dir, read_flat_yaml, kind,
                                    keep=kind == "deit")
        r = cls[kind]
        log_new_path(f"{CLS_NAMES[kind]} ECoFLaP (scripts/llama/image_classifiers.sh + block "
                     f"MeZO, {CLS_FIRST_STAGE} samples)", r["ecoflap_counts"], r["ecoflap"])
        log(f"{CLS_NAMES[kind]} (phase {n}): {time.time() - t0:.1f} s in all | Wanda alone: prune "
            f"{r['wanda']['prune']} s, sparsity {r['wanda']['sparsity']}, launches "
            f"{r['wanda_counts']} | ECoFLaP: prune {r['ecoflap']['prune']} s, "
            f"{r['ecoflap_counts']['perturb_inplace']} kernel-1 launches (3 x "
            f"{CLS_TARGETS[kind]} targets x {CLS_FIRST_STAGE // CLS_BATCH} microbatches), "
            f"{CLS_TARGETS[kind] - r['ecoflap']['zero_scores']} non-zero scores of "
            f"{CLS_TARGETS[kind]} in {r['ecoflap']['distinct_nonzero']} values, from "
            f"{r['ecoflap']['scores'][0]} to {r['ecoflap']['scores'][1]} | classification from the .pth (evaluate "
            f"CLI, synthetic, float32): {r['eval']['wall']:.1f} s, agg_metrics "
            f"{r['eval']['agg']}, launches {r['eval_counts']} | peak "
            f"{r['peak']:.2f} GiB | {smi}")
        phase_ended(n)
    # -- 21. BLIP-2 OPT-2.7B captioning ---------------------------------------------
    t0 = time.time()
    opt_counts, o = blip2_opt_path(torch, kernels, out_dir)
    log(f"BLIP-2 OPT-2.7B captioning (evaluate CLI, synthetic, {OPT_EVAL_BATCHES} batches of "
        f"{BATCH_SIZE}, beam {OPT_POINT['num_beams']}, {OPT_POINT['max_new_tokens']} tokens, "
        f"min length {OPT_POINT['min_length']}): {o['cli_wall']:.1f} s incl. model init | "
        f"generate walls " + ", ".join(f"{w:.3f}" for w in o["generate_s"]) + " s | every "
        f"caption >= {OPT_POINT['min_length']} tokens with its prompt (shortest "
        f"{o['shortest']}), {o['finished']} of {OPT_EVAL_BATCHES * BATCH_SIZE} rows finished, "
        f"finite metrics (CIDEr {o['cider']}) | decode step {o['step_ms']:.3f} ms against a "
        f"{o['bound_ms']:.3f} ms weight-read bound ({o['step_bytes'] / 1e9:.2f} GB a step), "
        f"{o['launches_per_step']:.0f} CUDA launches and "
        + ("not measured" if o["busy_ms_per_step"] is None
           else f"{o['busy_ms_per_step']:.3f} ms") + " device time a step | peak "
        f"{o['peak']:.2f} GiB | launches {opt_counts} | {time.time() - t0:.1f} s in all | {smi}")
    phase_ended(21)
    # -- 22. stage-1 Q-Former retrieval -----------------------------------------------
    t0 = time.time()
    q = qformer_path(torch, kernels, out_dir)
    log(f"Q-Former retrieval (evaluate CLI, tiny): card metrics equal to the CPU's, "
        f"{q['metrics']} | --model_scale full ends with the JAX message: {q['refusal']!r} | "
        f"launches {q['counts']} | {time.time() - t0:.1f} s in all")
    phase_ended(22)
    # -- 23. the mesh on the card -------------------------------------------------------
    t0 = time.time()
    kept = cls["deit"]["kept"]
    try:
        m = mesh_path(torch, kernels, kept)
    finally:
        shutil.rmtree(kept["dir"], ignore_errors=True)
    log(f"mesh (phase 23): (a) NCCL group of world size 1 in {m['init_s']:.2f} s, then "
        f"phase 19's DeiT-B ECoFLaP run through the prune CLI with --mesh dp=1,tp=1: "
        f"{m['wall']:.1f} s incl. model init, {m['counts']['perturb_inplace']} kernel-1 "
        f"launches (3 x {CLS_TARGETS['deit']} x {CLS_FIRST_STAGE // CLS_BATCH}), sparsity "
        f"dict byte-identical and {m['pth_tensors']} .pth tensors equal to phase 19's | "
        f"(b) torchrun --nproc-per-node 1 evaluate CLI --mesh dp on that .pth with its "
        f"head planted on phase 19's images (least margin {m['plant_margin']:.3f}): "
        f"{m['torchrun_s']:.1f} s, agg_metrics {m['agg']} (planted 50.0) | (c) each tp "
        f"rank's linear() in turn, the collectives joined, bf16, "
        f"{TP_TOKENS} tokens, against the unsharded product (max bf16 ulps at a floor "
        f"of RMS x {TP_ULP_FLOOR:g} / at RMS / 256 / share within 1 ulp, no floor): "
        + ", ".join(f"{name} tp={tp} " + " ".join(
            f"{k} {v['ulps']:g} / {v['ulps_at_rms/256']:g} / {v['share_1ulp_no_floor']:.6f}"
            for k, v in r.items()) for (name, tp), r in m["tp"].items())
        + f" ({m['tp_s']:.2f} s) | {time.time() - t0:.1f} s in all | {smi}")
    phase_ended(23)
    serial = (llama_counts, t5_counts, eva_counts, clip_counts, blip1_counts,
              cls["deit"]["ecoflap_counts"], cls["convnext"]["ecoflap_counts"])
    assert sum(weights["perturb_inplace"].values()) == sum(
        c["perturb_inplace"] for c in serial) + blip_counts["perturb_inplace"]
    assert sum(weights["perturb"].values()) == blip_counts["perturb"] + sum(
        c["perturb"] for c in serial)
    paths = {"blip2_t5": blip_counts, "llama": llama_counts,
             "llama_first_order": llama_fo_counts, "blip2_t5_first_order": blip_fo_counts,
             "blip2_t5_sparsegpt": sgpt_counts, "blip2_t5_global_mag": mag_counts,
             "blip2_t5_global_gradmagabs": grad_counts, "blip2_t5_eval_vqa": eval_counts,
             "llama_wikitext_ppl": ppl_counts, "t5": t5_counts, "t5_mmlu": mmlu_counts,
             "eva_clip": eva_counts, "clip": clip_counts, "blip1_upop_caption": blip1_counts,
             "blip1_eval_captioning": blip1_eval_counts,
             "deit": cls["deit"]["wanda_counts"], "deit_ecoflap": cls["deit"]["ecoflap_counts"],
             "convnext": cls["convnext"]["wanda_counts"],
             "convnext_ecoflap": cls["convnext"]["ecoflap_counts"],
             "blip2_opt_eval_captioning": opt_counts, "deit_ecoflap_mesh": m["counts"]}
    by_path = {k: {p: c[k] for p, c in paths.items()} for k in kernels}
    launches = {k: sum(by_path[k].values()) for k in kernels}
    log(json.dumps({"kernels": [
        {"name": "perturb_inplace", "route": "cuda",
         "source": "ecoflap_tpu_torch/csrc/perturb.cu",
         "replaces": "ecoflap_tpu/ops/perturb.py:54",
         "launches": launches["perturb_inplace"],
         "launches_by_path": by_path["perturb_inplace"], "max_abs_err": worst_err,
         "ms": avg("ms"), "plain_ms": avg("plain_ms"),
         "bound_ms": p_bound, "bound_by": p_by, "library_ms": None,
         "bound_share": p_bound / avg("ms"), "wrapper_ms": avg("wrapper_ms"), "host_us": host,
         "ptxas": usage.get("perturb") or None},
        {"name": "perturb", "route": "cuda",
         "source": "ecoflap_tpu_torch/csrc/perturb.cu",
         "replaces": "ecoflap_tpu/ops/perturb.py:31",
         "launches": launches["perturb"], "launches_by_path": by_path["perturb"],
         "max_abs_err": oop_err, "ms": oop_avg("ms"), "plain_ms": oop_avg("plain_ms"),
         "bound_ms": o_bound, "bound_by": o_by, "library_ms": None,
         "bound_share": o_bound / oop_avg("ms"), "wrapper_ms": oop_avg("wrapper_ms")},
        {"name": "flash_attention", "route": "cuda",
         "source": "ecoflap_tpu_torch/csrc/flash_attn.cu",
         "replaces": "ecoflap_tpu/ops/attention.py:189",
         "launches": launches["flash_attention"],
         "launches_by_path": by_path["flash_attention"],
         "max_abs_err": flash_err[FLASH_SHAPES[0]][0],
         "ms": flash_t["ms"], "plain_ms": flash_t["plain_ms"],
         "bound_ms": fb, "bound_by": fby, "library_ms": flash_t["library_ms"],
         "bound_share": fb / flash_t["ms"], "ptxas": usage.get("flash_attn") or None},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "ecoflap_tpu_torch/csrc/flash_attn_bwd.cu",
         "replaces": "ecoflap_tpu/ops/attention.py:189",
         "replaces_library_kernels": ["_flash_attention_bwd_dkv", "_flash_attention_bwd_dq"],
         "launches": launches["flash_attention_bwd"],
         "launches_by_path": by_path["flash_attention_bwd"],
         "max_abs_err": bwd_err[FLASH_SHAPES[0]][0],
         "ms": bwd_t["ms"], "plain_ms": bwd_t["plain_ms"],
         "bound_ms": bb, "bound_by": bby, "library_ms": bwd_t["library_ms"],
         "bound_share": bb / bwd_t["ms"], "ptxas": usage.get("flash_attn_bwd") or None},
    ]}))
    log(f"chip_smoke: {time.time() - t_start:.1f} s in all")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
