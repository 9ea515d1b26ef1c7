#!/usr/bin/env python3
"""Drive the PyTorch port (m_cedm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each printing JSON lines:
  1. device   the card (nvidia-smi name and power limit), torch and CUDA
              versions, and the seconds nvcc took to build the kernels
  2. kernel   each CUDA kernel against its plain PyTorch version at the
              flagship shapes (every K2 mode the U-Net uses), with max abs and
              relative error beside the tolerance, and kernel vs plain time
              (CUDA events, median of 10 runs of 10 back-to-back calls); K2's
              linear modes (act=False) also against
              torch.nn.functional.conv2d, and K4 against
              scaled_dot_product_attention. The narrow-channel kernel (K2's
              linear mode at C <= 8 or O <= 8) in each of its modes: the
              flagship's conv_in (C 4) and out conv (O 2), adm_edm_cond_h's
              (C 2, O 1), beside conv2d and the old route (gnsc_kernel on
              the same operands). K1's statistics pass at the main path's
              shapes, the 32x32 sites ((B, 1024, 64) and (B, 1024, 128), the
              summary mode), then at res 128 as context
  3. forward  one full-width U-Net forward (B = 16, res 128, ch 64, the four
              attention sites), kernel path against the plain path
  2b. backward each backward kernel against autograd of its plain forward at
              the flagship shapes (every K2 mode the U-Net's train step
              uses), every gradient output's max abs and relative error
              beside the tolerance, kernel vs plain time of the backward
              alone, and scaled_dot_product_attention's time for K4 and
              conv2d's autograd backward for K2's linear modes; K2's and
              K3's wgrad and dgrad kernels also called directly (each with
              the reduce of its partials), their 3xTF32 bound beside the
              fp32 one, and for the activated modes conv2d's backward of
              the conv alone as labelled context (not the same function);
              the narrow backward (the out conv) also called directly
              beside K2's dgrad and wgrad on the same operands; K1's
              backward at res 128 and 64, also called directly, two calls
              asserted to give the same bits, with ATen's
              native_group_norm_backward on the precomputed dy * gamma as
              labelled context (no SiLU derivative: not the same function)
  4. eval     McedmTask.eval_step for mask task "u" at B = 16 with the
              flagship sampler (50 Heun steps, S_churn 15) on seeded synthetic
              shallow-water fields, on the kernel path with every launch
              counter read (per U-Net forward: 2 narrow launches, 28 of
              gnsc_kernel, asserted); then the plain path and the kernel path in turns,
              three timed evals each (median reported), and the two paths'
              metrics held to each other
  5. train    McedmTask.train_step at B = 16, full width and depth: three
              steps from one state on the kernel path (launch counters read)
              and on the plain path, loss, gradient norm, params and EMA held
              to each other, K1's backward and K2's launches per step
              asserted; then ms per step on both paths (median of the
              timed steps after warm-up) and one profiled kernel-path step
  6. linear   K5 kv_dots and K6 apply_dots, the OFormer's linear attention,
              at its two shapes (BH = 16 and 64 head-batches, N = 16,384,
              D = E = 128) against their plain versions, and the backward of
              each autograd Function (made of the two kernels) against
              float64 autograd of its plain forward; kernel, plain and
              torch.bmm times, their bounds in 3xTF32 beside the fp32 ones; the
              backward's products through torch.bmm timed beside it, with
              its bound
  7. oformer eval   OformerTask.eval_step of configs/model/oformer_t.yaml at
              B = 16, full width and depth (16,384 tokens), on seeded
              synthetic shallow-water fields tokenized as the OFormer
              datamodule does, kernel path against plain path, launches read
  8. oformer train  three OformerTask.train_steps at B = 16 on both paths
              (the same dropout masks, the constant lr), loss, gradient norm
              and params held to each other; then one kernel-path step from
              each of the plain path's three states, its loss and gradient
              norm held to the plain step's; ms per step on both paths, one
              profiled kernel-path step and the peak device memory
  9. mega kernel  K7, the whole ADM block in one cooperative launch, against
              its plain version at the flagship's shapes (identity with
              chained stats, the decoder's dual input with a projection, the
              up block) and one ragged case, output and emitted stats within
              4e-5 of scale; kernel, plain and two-kernel-path (K2 + K2, or
              K3 + K2) times, the 3xTF32 bound beside the fp32 one, the
              occupancy, items and grid of each launch and the ptxas
              register and spill counts of both kernel instances; its
              recompute backward against float64 autograd of the plain
              composition
  10. mega eval   phase 4's eval (same state and noise) with mega=True:
              metrics within 1e-4 of the per-conv kernel path, the observed
              channel held, launches asserted (13 K7, 4 K2, 2 narrow, 0 K3,
              4 K4 and 5 K1 channel_stats per forward), samples/s of both
              paths in turns
  11. cond edm    CondEdmTask of configs/model/adm_edm_cond_h_res32.yaml at B =
              16, full width and depth, 50 Heun steps with S_churn 15, on the
              kernel path with mega=True and on the plain path: metrics
              within 1e-4, the sample of both paths within 1e-4 of scale,
              launches asserted, samples/s of both
  12. cli     the flagship through the port's entry points at full width and
              depth: m_cedm_tpu_torch.run on
              configs/config_adm_edm_mcedm_res32.yaml with system=swe_per on
              seeded shallow-water fields at res 128 (64 train and 16 test
              trajectories, written as h5 where h5py is installed, else
              served to the datamodule as in-memory stores), one epoch of 2
              steps at batch 32, validation, the test (50 Heun steps,
              S_churn 15, n_samples 5 folded into one sampler call); a
              resume to epoch 2; m_cedm_tpu_torch.eval_model on the resumed
              run. Every logged metric finite, the metric keys the JAX
              package's, the resumed run trains epoch 1 only, eval_model's
              test metrics within 1e-4 of the run's, launches per train step
              and per U-Net forward as in phases 4 and 5; seconds of the
              three, ms per train step, the test's samples/s, the
              checkpoint's MB. Then every flagship kernel against its
              plain version at the CLI's shapes: the fit's checkpoint
              restored into the kernel path and the plain path, one train
              step on the CLI's B = 32 batch (loss and gradient norm within
              1e-4, params within 2 lr) and the test eval at batch 80
              (metrics and mean sample within 1e-4); and the folding
              itself: phase 4's eval with 5 members and fixed noise, its
              mean sample within 1e-4 of scale of 5 single-member evals
  13. baselines   the paper's diffusion baselines at full width and depth,
              B = 16: K2 (identity 64 -> 64 and the projection over the
              128-channel concat, res 128, 64, 32, chained statistics) and
              K1's apply (C 64, 128) at the DDPM U-Net's 32 groups and eps
              1e-6 against their plain versions, forward and backward,
              with times; DdimTask (configs/model/ddim_res32.yaml: the DDPM
              U-Net) with its RePaint Heun sampler and with RePaint DDIM
              (ddim_sampler.yaml), kernel path against plain path (metrics
              within 1e-4 but UNHELD_METRICS, sample within 1e-4 of scale,
              the known channel within 1e-5 of the ground truth; beside
              each test_pde_loss gap its spread under the kernel path's
              sample difference with random signs, and the clamped
              residual held within 1e-4), three
              train steps on both paths (the self-conditioning branch
              injected), temb_proj's gradient; CondDdimTask on the DDPM
              and on the ADM U-Net (also mega=True) and CondEdmTask on the
              DDPM U-Net, one eval and three train steps each on both
              paths; CondEdmTask on the ADM U-Net, three train steps; the
              launches per U-Net forward and per train step asserted; then
              configs/config_ddim_res32.yaml through m_cedm_tpu_torch.run
              (one epoch of 2 steps at batch 32, validation, the test at
              batch 80), its metric keys the JAX package's, with seconds,
              ms per step and the test's samples/s; then every DDPM kernel
              against its plain version at the CLI's shapes, as in phase
              12 (a train step at B = 32, the folded test at B = 80;
              test_pde_loss reported)
  14. fno, time prediction   the FNO (configs/model/fnostatereconstr2d.yaml:
              width 32, 5 layers, modes 12, padding_t 4) at B = 32 on seeded
              fields at T = X = 128: its fp32 forward within 1e-5 of scale
              of float64 with TF32 turned on beforehand (the model turns it
              off), the truncated-DFT route against rfft2 (module functions
              called directly at the first layer's padded shape) within
              2e-5 with both times, the eval's 7 metrics, 3 train steps
              against float64 (loss and gradient norm 1e-4, params
              2 lr steps), ms per step and the eval's samples/s; then
              configs/config_fnostatereconstrabs2d.yaml through run.main (1
              epoch of 2 steps at batch 32, validation, the test), a resume
              to epoch 2 and eval_model as phase 12 (the JAX package's keys,
              no kernel launched); then OformerTimePredTask (oformer_t with
              (u, s) in and out, T = 128 split at n_history 64: 8,192 input
              and 8,192 propagate tokens) at B = 16, its eval and 3 train
              steps on both paths as phases 7 and 8 (launches 6 / 6 an
              eval, 12 / 24 a step asserted); K5 and K6 at N = 8,192 as
              phase 6; then the two two-stage test_steps:
              OformerStateTimePredTask kernel path against plain path
              (1e-4; 12 / 12 launches), FnoStateTimePredTask fp32 against
              float64 (1e-4 of scale) under both flip_xy
  15. bf16    bf16 serving of the flagship: (1) every bf16 kernel (K1's
              statistics and apply, K2 in every mode of the U-Net at res
              128, 64 and 32, the narrow conv's conv_in and out conv, K3, K4
              at 32x32) against its bf16 plain version (outputs within 1e-2
              of scale at most and 1e-4 on average, emitted statistics
              within 1e-5), with times, bf16 bounds (bytes at 3.35 TB/s
              against products at 989 TFLOP/s; K1 fp32 element work at 67;
              K4 at its least work that keeps fp32 accuracy, q k^T one
              bf16 product and P V three, P in three bf16 pieces, all at
              989, the TF32-split bound of earlier slices beside; K4's
              SASS, every product a wgmma; K1's statistics at the
              32x32 sites first, as phase 2, each asserted to give the
              same bits on a repeat; K1's apply at its main-path sites,
              (B, 16384, 64) and (B, 4096, 64) with chained statistics,
              on the card's clock, then its own-statistics pass at C 128
              as context) and the bf16 library
              call where one computes the same function (conv2d, SDPA); with
              torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
              turned on for the rest of the phase: (2) the full-width U-Net
              forward through a bf16 McedmTask's net_apply, kernel path
              against plain path within 2e-2 of scale, its mean gap below
              the plain bf16 forward's mean gap to the fp32 forward and its
              own mean gap to the fp32 forward at least half that, and one
              profiled bf16 and fp32 forward (device time,
              device operations, idle share); (3) phase 4's eval with model.dtype bfloat16, kernel
              path against plain path (metrics within 2e-2 relative,
              test_pde_loss_u reported, h within 1e-5 of the truth, the
              kernel-vs-plain sample gap below the bf16-vs-fp32 gap,
              launches equal to phase 4's), samples/s of the bf16 eval and
              the fp32 per-conv eval in turns; (4) the glue matmuls
              (layers.matmul, a 1x1 Conv2d) within one bf16 rounding of
              float64 with the flag on, at K 64 and 8192; (5)
              m_cedm_tpu_torch.eval_model with +model.hparams.model.dtype=
              bfloat16 on phase 12's resumed run: its keys those of phase
              12's eval_model, every metric finite, launches per U-Net
              forward equal to part 3's, its seconds; (6) the bf16 K7
              (unet_block_bf16_tma_kernel, and unet_block_bf16_kernel where
              TMA cannot describe the shapes) through its wrapper against
              its bf16 plain version (the chained composition of the bf16
              plain K2 / K3) at the flagship's widths: every launch kind of
              its forward (the identity block at res 128, 64 and 32, the
              decoder's dual input with its projection at the same three,
              the up blocks to res 128 and 64), the ragged case whose
              weights stream and the width-36 case of the kept route, all
              with chained statistics and emitting (outputs within 1e-2 /
              1e-4 of scale, statistics within 4e-5, the same bits on a
              repeat), kernel, plain and bf16 two-kernel-path times on the
              wrapper's and the card's clock, the bf16 bound, each case's
              route and launch plan, a forward's launch-weighted sums, and
              the SASS (every product a wgmma, the TMA route's copies and
              stores TMA's); (7) phase 15.3's eval with
              mega=True: metrics within 2e-2 of the bf16 per-conv eval's
              (test_pde_loss_u reported), h within 1e-5 of the truth, every
              launch equal to the fp32 mega eval's of phase 10 (1,287 K7),
              samples/s of both in turns; (8) CondEdmTask (phase 11's
              inputs) and the ADM CondDdimTask (phase 13's) in bf16 with
              mega=True against their bf16 plain path: metrics within 2e-2
              (test_pde_loss reported), the sample's gap to the plain path
              under its gap to the fp32 mega eval, launches per forward as
              phase 10's, samples/s of both in turns
  16. bf16 training   the flagship's bf16 train step: (1) every bf16
              backward kernel (K1's at res 128 and 64; K2 in every mode of
              the train step: the identity tail with chained statistics,
              identity_up, the projection from the 128-channel concat, the
              128-channel decoder conv0, conv_in's weight gradient, the
              down blocks' linear conv0; K3; the narrow out conv; K4 at
              32x32) called directly against its bf16 plain version (bf16
              outputs within 1e-2 of scale at most and 1e-4 on average; the
              fp32 dW, dbias, dgamma, dbeta within 1e-3 of scale; K4's o32
              within 1e-5 of the fp32 plain forward), with times, bf16
              bounds (bytes at 3.35 TB/s against bf16 products at 989
              TFLOP/s; K1 fp32 element work at 67; K4's S and dP one bf16
              product each and P^T g, dS K and dS^T Q three each, the
              TF32-split bound beside; K4's two kernels' SASS, every product
              a wgmma; their gradients asserted bit for bit on a repeat),
              the library's time (the
              autograd backward of bf16 conv2d, of bf16 SDPA), and the
              device time (CUDA events behind a spin kernel) of the bf16
              kernels and of the fp32 kernels on the same inputs upcast;
              each K2 / K3 case's device time split into wgrad, dgrad and
              the dx pass (at the identity tail also the dx pass as the
              earlier PyTorch passes on the same da); the dx kernel (gn_dx)
              alone on K2's bf16 da and K3's fp32 low-res da; K1's bf16
              backward also at K1_BWD_BF16_RAGGED, each case with its plan
              and its bits on a repeat; conv_in's wgrad alone at C 4 and 2
              and WGRAD_BF16_RAGGED, with its plan and its bits on a
              repeat, beside bf16 convolution_backward of dW and dbias
              alone (the same function), and the out conv's wgrad beside
              the same; one device operation a K1 call (profiler) and the
              SASS of K1's (no floating-point atomic) and the wgrad's (HGMMA,
              no FFMA) asserted before phase 1 (k1_bwd_bf16_checks); (2)
              McedmTask.train_step with model.dtype bfloat16 at B = 16, full
              width and depth, from phase 5's state: kernel path against
              the bf16 plain path over 3 steps (loss and gradient norm
              within 1e-2 relative, params within 2 lr steps), the kernel
              path's gradient gap to the fp32 kernel step at most 1.5 times
              the plain path's, the launches per step equal to phase 5's
              (asserted), ms per step of the bf16 and the fp32 step in
              turns, and one profiled bf16 step (its device busy beside
              PARENT_BF16_STEP_BUSY_MS, the step's before the bf16 K2 / K3
              backward's redesign); (3)
              configs/config_adm_edm_mcedm_res32.yaml with
              trainer.precision=bf16 through m_cedm_tpu_torch.run (fit and a
              resume to epoch 2) and m_cedm_tpu_torch.eval_model on the
              resumed run: phase 12's key set, every metric finite, the
              checkpoint's params, Adam state and EMA fp32, the launches per
              train step equal to part 2's, seconds
  17. oformer bf16   the OFormer with trainer.precision bf16: (1) K5's and
              K6's bf16 instances (bf16 k, v into fp32; bf16 q with the
              factor rounded to bf16, the output rounded once) through
              their wrappers at BH = 16 and 64, N = 16,384 and 8,192, a
              ragged case (BH 3, N 1,037, D = E = 40), BH 20 (clusters
              that do not tile the SMs) and width 36 (the mma.sync
              route), K6 with an fp32 and a bf16 factor, against their bf16
              plain versions (K5 2e-5 of scale, K6 1e-2 / 1e-4) and
              float64 (K5 2e-5, K6 one rounding: 1e-2), the same
              bits on a repeat, each Function's backward against float64
              autograd with the VJP's roundings (bf16 gradients 1e-2 of
              scale, ddots 2e-5), each case's route and K5 cluster, kernel,
              plain and library times (K5: torch.bmm with out_dtype
              float32, the same function, bf16-out bmm beside; K6: bf16
              torch.bmm), the bf16 bound; the clusters the card holds at
              once, one device kernel a K5 call (profiler) and the TMA
              kernels' SASS (HGMMA and UTMALDG in both, UTMASTG in K6)
              asserted, taken before phase 1 (late profiles lose device
              events); (2) OformerTask in bf16 at B = 16, full width
              and depth, kernel path against the bf16 plain path: an eval
              (metrics and prediction within 2e-2; launches 6 bf16 K5 and
              6 bf16 K6, no fp32 one, asserted), three train steps (12 / 24
              a step asserted; a kernel step from each plain state within
              2e-2 in loss and gradient norm; params within 2 lr a step;
              the state fp32), eval and step walls of bf16 and fp32 in
              turns, one profiled bf16 step; (3) the same for
              OformerTimePredTask (8,192 + 8,192 tokens); (4)
              config_oformer_t.yaml with trainer.precision=bf16 through
              m_cedm_tpu_torch.run (fit, a resume to epoch 2) and
              eval_model with +model.hparams.dtype=bfloat16 on phase 12's
              seeded fields: the JAX package's keys, every metric finite,
              the checkpoint fp32, each step's and eval's launches those
              of part 2, seconds

Then the per-kernel summary line {"kernels": [...]} (flagship forward
launches counted in the kernel-path eval of phase 4, backward launches in the
kernel-path train steps of phase 5; K5 and K6 in one OFormer eval of phase 7,
with their launches per OFormer train step beside; K7 in the mega eval of
phase 10, with phase 11's beside; every flagship kernel's launches in phase
12 as `launches_cli`; the DDPM U-Net's kernels' launches in phase 13's
RePaint Heun eval and first train step as `launches_ddim_eval` and
`launches_ddim_step`, and K1's and K2's times at its 32 groups as
`at_32_groups`; K5's and K6's launches per time-prediction eval and step
of phase 14 and their N = 8,192 cases as `at_n_8192`; then the bf16
variants, named with " bf16", their launches counted in phase 15's bf16
eval, their times and bounds from phase 15's first part, each with its
modes; K7's bf16 instance with its launches in phase 15.7's bf16 mega eval
(CondEdmTask's of 15.8 beside) and its times and bound from 15.6; then
the bf16 backward kernels, named with " bf16", their launches
counted in phase 16's three kernel-path bf16 train steps, their times and
bounds from phase 16's first part; K5's and K6's bf16 instances last, their
launches counted in phase 17.2's eval, a step's and 17.3's beside, their
times and bounds from 17.1), the nvidia-smi line, and the last line
names the device. `bound_ms` is the least time the card could take for a kernel's work
at the timed shape: the larger of its bytes (each input read once, each
output written once) over 3.35 TB/s and its FLOPs over the 67 TFLOP/s fp32
peak of an H100 SXM for the kernels that run fp32 on the CUDA cores; K2/K3
(gnsc_kernel), K4, K5, K6 and K7 run their products as 3xTF32 on the tensor
cores, and so does the K2/K3 backward (wgrad, dgrad): three TF32 FLOPs per
fp32 FLOP over the 495 TFLOP/s TF32 peak (their CUDA-core bound beside, as
`bound_fp32_ms`). K2's linear modes are listed in its rows
and in the narrow kernel's under `act_false_modes`, each with its time,
bound and conv2d time (the narrow kernel's with the old route's time). The plain versions
run with TF32 off (kernels._launch.fp32_reference_math). Every failed check
raises, so the exit code is non-zero; with no CUDA device the script exits 2
before printing any result.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

import numpy as np

# identical to the `hparams` block of configs/model/adm_edm_mcedm_res32.yaml
# (a test holds the two equal), so no YAML reader is needed here
FLAGSHIP_HPARAMS = {
    "name": "adm_edm_mcedm",
    "model": {
        "in_channels": 2, "cond_channels": 2, "cat_cond": True, "out_ch": 2,
        "ch": 64, "ch_mult": [1, 1, 1], "num_res_blocks": 1,
        "attn_resolutions": [32], "dropout": 0.0, "label_dim": 0,
        "augment_dim": 0, "label_dropout": 0, "ema_rate": 0.999, "ema": True,
        "resamp_with_conv": True, "resolution": 128, "self_cond": False,
        "cond_p": 1.0, "dx_cond": False, "cat_dx": False, "dx_norm": "l2",
        "dx_detach": False, "add_cond_mask": False, "add_xt": False,
    },
    "data": {
        "normalization": "gauss", "uniform_dequantization": False,
        "gaussian_dequantization": False, "rescaled": False,
    },
    "optimization": {
        "optimizer": "Adam", "lr": 0.0002, "weight_decay": 0.0, "beta1": 0.9,
        "amsgrad": False, "eps": 1.0e-08, "grad_clip": 1.0, "loss": "l2",
        "pde_loss_lambda": 0.0, "pde_loss_prop_t": False, "use_gt_pde": False,
        "factor": 0.3, "step_size": 50,
    },
    "sampler": {
        "name": "edm", "type": "edm", "timesteps": 50, "sigma_min": 0.002,
        "sigma_max": 80, "rho": 7, "S_churn": 15.0, "S_min": 0, "S_max": "inf",
        "S_noise": 1, "n_samples": 1, "n_repeat": 2, "n_time_h": 128,
        "n_time_u": 0, "return_last": True, "select_by_pde": False,
        "use_gt_pde_select": True, "guide_dx": False, "w": 0.0,
        "plot_scaled": False,
    },
}

# identical to the `hparams` block of configs/model/adm_edm_cond_h_res32.yaml,
# the conditional EDM baseline served by CondEdmTask (a test holds the two
# equal)
COND_EDM_HPARAMS = {
    "name": "adm_edm_cond_h",
    "model": {
        "in_channels": 1, "cond_channels": 1, "cat_cond": True, "out_ch": 1,
        "ch": 64, "ch_mult": [1, 1, 1], "num_res_blocks": 1,
        "attn_resolutions": [32], "dropout": 0.0, "label_dim": 0,
        "augment_dim": 0, "label_dropout": 0, "ema_rate": 0.999, "ema": True,
        "resamp_with_conv": True, "resolution": 128, "self_cond": False,
        "cond_p": 1.0, "dx_cond": False, "cat_dx": False, "dx_norm": "l2",
        "dx_detach": False, "add_cond_mask": False, "add_xt": False,
        "type": "simple", "var_type": "fixedsmall", "node_type": False,
    },
    "data": {
        "normalization": "gauss", "uniform_dequantization": False,
        "gaussian_dequantization": False, "rescaled": False,
    },
    "optimization": {
        "optimizer": "Adam", "lr": 0.0002, "weight_decay": 0.0, "beta1": 0.9,
        "amsgrad": False, "eps": 1.0e-08, "grad_clip": 1.0, "loss": "l2",
        "pde_loss_lambda": 0.0, "pde_loss_prop_t": False, "use_gt_pde": False,
        "factor": 0.3, "step_size": 50,
    },
    "sampler": {
        "name": "edm", "type": "edm", "timesteps": 50, "sigma_min": 0.002,
        "sigma_max": 80, "rho": 7, "S_churn": 15.0, "S_min": 0, "S_max": "inf",
        "S_noise": 1, "n_samples": 1, "n_repeat": 2, "n_time_h": 128,
        "n_time_u": 0, "return_last": True, "select_by_pde": False,
        "use_gt_pde_select": True, "guide_dx": False, "w": 0.0,
        "plot_scaled": False,
    },
    "diffusion": {
        "beta_schedule": "linear", "beta_start": 0.0001, "beta_end": 0.02,
        "num_diffusion_timesteps": 1000,
    },
}
COND_EDM_TARGET = "m_cedm_tpu.tasks.CondEdmTask"

# identical to the `hparams` block of configs/model/oformer_t.yaml (a test
# holds the two equal)
OFORMER_HPARAMS = {
    "name": "oformer_t", "time_history": 128,
    "encoder": {
        "input_channels": 3, "time_window": 1, "in_emb_dim": 128,
        "out_channels": 128, "max_node_type": 2, "heads": 1, "depth": 4,
        "res": 128, "use_ln": True, "emb_dropout": 0.0, "relative_emb_dim": 2,
    },
    "decoder": {
        "max_node_type": 2, "latent_channels": 128, "out_channels": 1,
        "res": 128, "scale": 2, "dropout": 0.1, "relative_emb_dim": 2,
    },
    "norm_shape": [], "loss": "mse", "lr": 0.001, "weight_decay": 1.0e-4,
    "curriculum_steps": 8, "curriculum_ratio": 0.2,
}
OFORMER_TARGET = "m_cedm_tpu.tasks.OformerTask"
OFORMER_GRAD_CLIP = 2.0  # configs/trainer/trainer_oformer.yaml
# linear-attention sites of one OFormer forward at depth 4: four encoder
# layers and the decoder's mix layer (BH = B) and its cross attention
# (4 heads, BH = 4 B); each runs K5 once and K6 once, and in the backward
# K5's VJP makes two K6 calls, K6's one K6 and one K5 call
OFORMER_SITES = 6
# the OFormer's time prediction (PlOformerSwpTimePredDatamodule, n_history
# 64 of T = 128): oformer_t with the (u, s) fields and the t, x coordinates
# in and the future (u, s) out; the same six linear-attention sites
TIMEPRED_HPARAMS = {**OFORMER_HPARAMS,
                    "encoder": {**OFORMER_HPARAMS["encoder"], "input_channels": 4},
                    "decoder": {**OFORMER_HPARAMS["decoder"], "out_channels": 2}}
TIMEPRED_TARGET = "m_cedm_tpu.tasks.OformerTimePredTask"
TIMEPRED_HISTORY = 64
# The time prediction's three-step trajectory, kernel path against plain
# path: its gradient norm jumps from about 5 to 47 and back to 19, and the
# trajectories' gap at step 2 reached 1.4-1.5e-4 on two seeds on one H100
# (PERF.md) while every step alone, held in both directions, stayed within
# 2.4e-5; so the trajectory's loss and gradient norm are held to 1e-3 and
# each step alone to TOL_TRAIN
TOL_TIMEPRED_TRAJECTORY = 1e-3

# identical to the `hparams` block of configs/model/fnostatereconstr2d.yaml
# (a test holds the two equal)
FNO_HPARAMS = {
    "name": "fno_state_reconstr_2d", "modes_1": 12, "modes_2": 12, "width": 32,
    "num_layers": 5, "padding_t": 4, "padding_x": 0, "inst_norm": False,
    "time_history": 128, "time_future": 0, "input_size": 1, "state_size": 1,
    "norm_shape": [], "factor": 0.3, "step_size": 50, "loss": "l1", "lr": 0.001,
    "weight_decay": 0,
}
FNO_TARGET = "m_cedm_tpu.tasks.FnoStateReconstrTask"
FNO_BATCH = 32  # configs/datamodule/datamodule_abs_coord.yaml
FNO_RES = 128  # T = X, the shipped data's grid

BATCH = 16
SEED = 0
TIMING_RUNS = 10
CALLS_PER_RUN = 10
# Tolerances, as max|kernel - plain| / max(1, max|plain|). Both sides are fp32
# (TF32 off); they differ only in summation order. A conv output sums up to
# 9 * 128 = 1152 products of O(1) terms, whose reordering moves the sum by a
# few ulp per term at worst: 2e-5 of the output scale bounds it with room.
# Emitted statistics sum 16384 pixels through fp32 atomics: same bound. The
# full forward chains about 25 such layers, so it gets 1e-4 (the JAX
# package's own bound against the torch reference is 1e-3).
TOL_KERNEL = 2e-5
TOL_FORWARD = 1e-4
# The known (observed) channel is clamped by the sampler: exact up to the
# normalizer's round trip
TOL_KNOWN = 1e-5
# The eval metrics of the kernel and plain paths: 99 U-Net calls whose
# outputs differ by about 1e-6 of their scale; the Heun steps do not
# amplify that by more than a few times
TOL_METRICS = 1e-4
EVAL_RUNS = 3  # timed evals per path, taken in turns; the median is reported
# Backward kernels against autograd of the plain forward run in float64 on the
# same inputs, as max|err| / max(1, max|reference|) per gradient output. A
# weight gradient sums 16 * 128 * 128 = 262,144 pixels, and dgamma / dbeta
# 16,384, in fp32 (per-block partials added in a fixed order, or fp32
# atomics); the rounding of such a sum grows with its length, so the bound
# is 1e-4 of the gradient's scale, with the JAX package's 1e-3 against the
# torch reference as the ceiling.
TOL_BWD = 1e-4
# The train step, kernel path vs plain path: the loss and gradient norm of
# each step to 1e-4 relative; after three Adam steps the parameters are held
# to 2 * lr * steps absolute, since Adam moves an entry by about lr whatever
# its gradient's size, and an entry whose gradient is near zero can take the
# other sign on rounding alone; the EMA moves 0.001 of that.
TOL_TRAIN = 1e-4
TRAIN_STEPS = 3
TRAIN_WARMUP, TRAIN_TIMED = 2, 10
PEAK_FLOPS = 67e12    # H100 SXM fp32, outside the tensor cores
PEAK_TF32 = 495e12    # H100 SXM TF32 tensor cores, dense
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
PEAK_BF16 = 989e12    # H100 SXM bf16 tensor cores, dense
L2_BYTES = 50 * 2**20  # H100 SXM L2

# name -> (CUDA source, the TPU kernel it replaces); the flagship's nine,
# then the OFormer's two
KERNEL_INFO = {
    "K1 gn_silu": ("m_cedm_tpu_torch/csrc/fused_norm.cu",
                   "m_cedm_tpu/pallas/fused_norm.py:132"),
    "K1 channel_stats": ("m_cedm_tpu_torch/csrc/fused_norm.cu",
                         "m_cedm_tpu/pallas/fused_norm.py:119"),
    "K2 gn_silu_conv": ("m_cedm_tpu_torch/csrc/fused_norm_conv.cu",
                        "m_cedm_tpu/pallas/fused_norm_conv.py:182"),
    "K2 narrow_conv": ("m_cedm_tpu_torch/csrc/narrow_conv.cu",
                       "m_cedm_tpu/pallas/fused_norm_conv.py:182"),
    "K3 gn_silu_up_conv": ("m_cedm_tpu_torch/csrc/fused_norm_conv.cu",
                           "m_cedm_tpu/pallas/fused_norm_conv.py:1070"),
    "K4 attention": ("m_cedm_tpu_torch/csrc/fused_attention.cu",
                     "m_cedm_tpu/pallas/fused_attention.py:48"),
    "K1 gn_silu_bwd": ("m_cedm_tpu_torch/csrc/fused_norm.cu",
                       "m_cedm_tpu/pallas/fused_norm.py:142"),
    "K2 gn_silu_conv_bwd": ("m_cedm_tpu_torch/csrc/fused_norm_conv_bwd.cu",
                            "m_cedm_tpu/pallas/fused_norm_conv.py:1294"),
    "K2 narrow_conv_bwd": ("m_cedm_tpu_torch/csrc/narrow_conv.cu",
                           "m_cedm_tpu/pallas/fused_norm_conv.py:1294"),
    "K3 gn_silu_up_conv_bwd": ("m_cedm_tpu_torch/csrc/fused_norm_conv_bwd.cu",
                               "m_cedm_tpu/pallas/fused_norm_conv.py:2497"),
    "K4 attention_bwd": ("m_cedm_tpu_torch/csrc/fused_attention.cu",
                         "m_cedm_tpu/pallas/fused_attention.py:63"),
    "K5 kv_dots": ("m_cedm_tpu_torch/csrc/linear_attention.cu",
                   "m_cedm_tpu/pallas/linear_attention.py:68"),
    "K6 apply_dots": ("m_cedm_tpu_torch/csrc/linear_attention.cu",
                      "m_cedm_tpu/pallas/linear_attention.py:129"),
    "K7 unet_block": ("m_cedm_tpu_torch/csrc/fused_block.cu",
                      "m_cedm_tpu/pallas/fused_block.py:122"),
}
OFORMER_KERNELS = ("K5 kv_dots", "K6 apply_dots")
MEGA_KERNELS = ("K7 unet_block",)  # the U-Net's sampling path with mega=True
FLAGSHIP_KERNELS = tuple(k for k in KERNEL_INFO
                         if k not in OFORMER_KERNELS + MEGA_KERNELS)
# Per U-Net forward at the flagship's and adm_edm_cond_h's shapes, K2's 30
# calls: conv_in, the three encoder blocks' two convs, the two down blocks'
# two, the two middle blocks' two, the six decoder blocks' two, the two up
# blocks' tail conv and the out conv. conv_in (C 4 or 2) and the out conv
# (O 2 or 1) take the narrow kernel, the other 28 gnsc_kernel. A train step
# runs one forward; its backward runs the narrow backward for the out conv
# and K2's backward kernels for the other 29 (conv_in among them).
NARROW_PER_FORWARD, K2_PER_FORWARD = 2, 28
K2_BWD_PER_STEP, NARROW_BWD_PER_STEP = 29, 1
# K1's backward: norm0 of the two down blocks (res 128 and 64) and the out
# head's norm (res 128)
K1_BWD_PER_STEP = 3
# With mega=True: K7 runs the 13 blocks that are not down blocks (three
# encoder blocks, the two middle blocks, six decoder blocks, two up blocks);
# K2 the two down blocks' two convs, the narrow kernel conv_in and out_conv;
# K4 the four attention sites; no K3 (the up blocks are K7's). K1's
# statistics pass runs where a block's input comes without statistics (after
# an attention site), as on the per-conv path: the two middle blocks, the
# res-64 up block, and the two res-32 decoder blocks over their one half
# without statistics
MEGA_LAUNCHES = {"K7 unet_block": 13, "K2 gn_silu_conv": 4, "K2 narrow_conv": 2,
                 "K3 gn_silu_up_conv": 0, "K4 attention": 4, "K1 channel_stats": 5}
# K7 against its plain version: two chained convs of up to 9 * 128 products
# each and a norm over the first one's output, in another summation order
TOL_MEGA = 4e-5
MEGA_RUNS = 2  # timed evals per path in phases 10 and 11, taken in turns


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = TIMING_RUNS, per_run: int = CALLS_PER_RUN) -> float:
    """Median time of one fn() on the card, after warm-up: each run brackets
    `per_run` back-to-back calls with CUDA events, so the card's queue stays
    full and a short kernel's time does not include the host's launch gap."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return float(np.median(times))


def compare(got, want, tol: float, name: str) -> dict:
    """max abs / relative error of got vs want; raises beyond tol."""
    import torch

    got, want = got.double(), want.double()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    rel = err / scale
    if rel > tol:
        raise AssertionError(f"{name}: error {err:.3e} (rel {rel:.3e}) beyond {tol:.1e}")
    return {"max_abs_err": err, "max_rel_err": rel, "tol": tol}


def bound(nbytes: float, flops: float, tf32_products: float = 0,
          peak: float = PEAK_FLOPS, bf16_flops: float = 0) -> dict:
    """The least time the card could take: bytes over the memory rate or
    FLOPs over the fp32 rate (`peak`: PEAK_BF16 for bf16 products),
    whichever is longer. A kernel whose products run as `tf32_products` TF32
    products on the tensor cores (3 for 3xTF32; 2 for a product with an
    fp32 P or dS in the bf16 K4's TF32-split bound) does that many TF32 FLOPs per FLOP over the TF32
    rate; its CUDA-core bound is kept beside as `bound_fp32_ms`.
    `bf16_flops`: the FLOPs of further products of bf16 operands, at
    PEAK_BF16 (K4's bf16 q k^T; k4_bf16_bound)."""
    t_bytes, t_fp32 = nbytes / PEAK_BYTES * 1e3, (flops + bf16_flops) / peak * 1e3
    t_ops = (tf32_products * flops / PEAK_TF32 * 1e3 if tf32_products
             else flops / peak * 1e3) + bf16_flops / PEAK_BF16 * 1e3
    rec = {"bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "flops": flops + bf16_flops}
    if bf16_flops:
        rec.update(bf16_flops=bf16_flops)
    if tf32_products:
        rec.update(bound_fp32_ms=max(t_bytes, t_fp32), tf32_products=tf32_products)
    return rec


def conv2d_library(x, w, bias):
    """torch.nn.functional.conv2d (cuDNN, TF32 off) computing K2's linear
    mode on the NHWC operands through channels-last views: the output in
    NHWC, as a view. The port never calls it."""
    import torch.nn.functional as F

    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), bias, padding=1)
    return y.permute(0, 2, 3, 1)


ACT_FALSE_KEYS = ("mode", "ms", "plain_ms", "library_ms", "library_max_rel_err",
                  "bound_ms", "bound_by", "bound_fp32_ms", "max_rel_err", "old_route_ms",
                  "kernel_call_ms", "old_route_call_ms", "wgrad_call_ms",
                  "dgrad_call_ms")


def nbytes(*tensors) -> int:
    """Bytes of the tensors at their own element size."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def conv_flops(b: int, h: int, w: int, c: int, o: int) -> float:
    return 2.0 * 9 * c * o * b * h * w


def seeded_params(model, seed: int):
    """Non-zero fan-in-scaled normal parameters from numpy (a fresh ADM init
    zeroes conv1, proj and out_conv, which would hide every kernel)."""
    import torch

    from m_cedm_tpu_torch.models.layers import Conv2d, Linear

    rs = np.random.RandomState(seed)
    params = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            shape = tuple(p.shape)
            if pname == "weight" and isinstance(mod, Linear):
                val = rs.randn(*shape) / math.sqrt(shape[1])
            elif pname == "weight" and isinstance(mod, Conv2d):
                val = rs.randn(*shape) / math.sqrt(int(np.prod(shape[:-1])))
            elif pname == "weight":  # norm scale
                val = 1.0 + 0.3 * rs.randn(*shape)
            else:
                val = 0.3 * rs.randn(*shape)
            key = f"{mname}.{pname}" if mname else pname
            params[key] = torch.from_numpy(val.astype(np.float32))
    return params


def synthetic_swe_batch(rs, b: int, res: int):
    """Smooth shallow-water-like (h, u) fields on a (T, X) grid: depth 1 plus
    travelling Gaussian bumps, velocity following the bumps; plus the
    normalized coordinate grids the mask datamodule returns."""
    t = np.linspace(0.0, 1.0, res)[:, None]
    x = np.linspace(-2.5, 2.5, res)[None, :]
    h = np.ones((b, res, res))
    u = np.zeros((b, res, res))
    for i in range(b):
        for _ in range(3):
            a, c = rs.uniform(0.1, 0.5), rs.uniform(-2.0, 2.0)
            v, w = rs.uniform(-1.0, 1.0), rs.uniform(0.2, 0.6)
            bump = a * np.exp(-((x - c - v * t) / w) ** 2)
            h[i] += bump
            u[i] += v * bump
    u /= h
    tg = np.broadcast_to(np.linspace(0, 1, res)[None, :, None, None], (b, res, res, 1))
    xg = np.broadcast_to(np.linspace(0, 1, res)[None, None, :, None], (b, res, res, 1))
    return (h[..., None].astype(np.float32), tg.astype(np.float32),
            xg.astype(np.float32), u[..., None].astype(np.float32))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> None:
    import torch

    from m_cedm_tpu_torch.kernels import _build

    smi = nvidia_smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    per_source = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln]
             for name in _build.SOURCES}
    emit({"phase": "device", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "build_s": build_s,
          "build_s_per_source": per_source, "ptxas": ptxas})


def phase_kernels(device, b: int, res: int, ch: int) -> dict:
    """Every kernel against its plain version; returns per-kernel summaries."""
    import torch

    from m_cedm_tpu_torch.kernels import fused_attention as fa
    from m_cedm_tpu_torch.kernels import fused_norm as fn
    from m_cedm_tpu_torch.kernels import fused_norm_conv as fnc
    from m_cedm_tpu_torch.models.layers import adm_groups

    g = torch.Generator(device=device).manual_seed(SEED)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=g, device=device) * scale + shift

    def fold(c):
        return rnd(b, c, scale=0.3, shift=1.0), rnd(b, c, scale=0.3)

    results = {}

    def flat(t):  # out, or (out, (sums, sumsq)), or (sums, sumsq)
        return [u for s in t for u in flat(s)] if isinstance(t, tuple) else [t]

    def check(kernel, mode, got, want, k_fn, p_fn, work=None, lib_fn=None,
              old_fn=None, device_fn=None):
        """`work`: (bytes, flops[, tf32 products]) of the kernel's call, given
        for the mode whose time the summary line reports (each kernel's
        first). `lib_fn`: the PyTorch call computing the same function, timed
        beside (its error against the plain version recorded, not held).
        `old_fn`: the route the kernel replaced, held to the plain version
        and timed beside. `device_fn`: timed on the card's clock as well
        (`device_ms`), where the wrapper's host cost exceeds the kernel's."""
        errs = [compare(a, w, TOL_KERNEL, f"{kernel} {mode} output {i}")
                for i, (a, w) in enumerate(zip(flat(got), flat(want), strict=True))]
        rec = {"phase": "kernel", "kernel": kernel, "mode": mode,
               **max(errs, key=lambda e: e["max_rel_err"]),
               "outputs_checked": len(errs)}
        rec["ms"] = cuda_ms(k_fn)
        rec["plain_ms"] = cuda_ms(p_fn)
        if work is not None:
            rec.update(bound(*work), library_ms=None)
        if device_fn is not None:
            rec["device_ms"] = device_ms(device_fn, bound(*work))
        if lib_fn is not None:
            rec["library_ms"] = cuda_ms(lib_fn)
            rec["library_max_rel_err"] = compare(
                lib_fn(), flat(want)[0], 1.0, f"{kernel} {mode} library")["max_rel_err"]
        if old_fn is not None:
            for i, (a, w) in enumerate(zip(flat(old_fn()), flat(want), strict=True)):
                compare(a, w, TOL_KERNEL, f"{kernel} {mode} old route output {i}")
            rec["old_route_ms"] = cuda_ms(old_fn)
        emit(rec)
        keep_result(results, rec)
        if lib_fn is not None:
            results[kernel].setdefault("act_false_modes", []).append(
                {k: rec[k] for k in ACT_FALSE_KEYS if k in rec})

    with torch.no_grad():
        n = res * res
        # K1 (down-block prefix / out-head norm), with and without chained stats
        c = ch
        x = rnd(b, n, c, scale=0.8, shift=0.2)
        gamma, beta = fold(c)
        gr = adm_groups(c)
        stats = fn.channel_stats_plain(x)
        # K1's statistics pass runs on the main path only where K2 gets no
        # chained statistics: after an attention block, at the 32 x 32 sites
        # ((B, 1024, 64) and the decoder's (B, 1024, 128)); the summary mode
        # is the first, res 128 is context
        g_st = torch.Generator(device=device).manual_seed(SEED + 1)
        for mode, xs in ((STATS_MODES[0], x_stats(b, res, c, g_st, device)),
                         (STATS_MODES[1], x_stats(b, res, 2 * c, g_st, device)),
                         (STATS_MODES[2], x)):
            st = fn.channel_stats_plain(xs)
            check("K1 channel_stats", mode, fn.channel_stats(xs), st,
                  lambda xs=xs: fn.channel_stats(xs), lambda xs=xs: fn.channel_stats_plain(xs),
                  work=(nbytes(xs, *st), 3.0 * xs.numel()),
                  device_fn=lambda xs=xs: fn.channel_stats(xs))
        want = fn.gn_silu_plain(x, gamma, beta, gr)
        # the first mode of each kernel is timed alone (chained stats): its
        # time is the one the summary line reports
        check("K1 gn_silu", "chained stats",
              fn.gn_silu(x, gamma, beta, gr, stats=stats), want,
              lambda: fn.gn_silu(x, gamma, beta, gr, stats=stats),
              lambda: fn.gn_silu_plain(x, gamma, beta, gr),
              work=(nbytes(x, gamma, beta, *stats, want), 6.0 * x.numel()))
        check("K1 gn_silu", "own stats pass", fn.gn_silu(x, gamma, beta, gr), want,
              lambda: fn.gn_silu(x, gamma, beta, gr),
              lambda: fn.gn_silu_plain(x, gamma, beta, gr))

        # K2, every mode of the U-Net at its full-resolution shape
        def k2(mode, x, gamma, beta, w, bias, **kw):
            groups = adm_groups(x.shape[-1]) if gamma is not None else 0
            got = fnc.gn_silu_conv(x, gamma, beta, w, bias, groups, **kw)
            plain_kw = {k: v for k, v in kw.items() if k != "stats"}
            want = fnc.gn_silu_conv_plain(x, gamma, beta, w, bias, groups, **plain_kw)
            b_, h_, w_, c_ = x.shape
            cr = kw["residual"].shape[-1] if kw.get("skip_w") is not None else 0
            work = (nbytes(x, gamma, beta, w, bias, *(kw.get("stats") or ()),
                           kw.get("residual"), kw.get("skip_w"), kw.get("skip_b"),
                           *flat(want)),
                    conv_flops(b_, h_, w_, c_, w.shape[-1])
                    + 2.0 * b_ * h_ * w_ * cr * w.shape[-1], 3)
            check("K2 gn_silu_conv", mode, got, want,
                  lambda: fnc.gn_silu_conv(x, gamma, beta, w, bias, groups, **kw),
                  lambda: fnc.gn_silu_conv_plain(x, gamma, beta, w, bias, groups,
                                                 **plain_kw), work=work,
                  lib_fn=None if gamma is not None else lambda: conv2d_library(x, w, bias))

        def conv_w(ci, co):
            return rnd(3, 3, ci, co, scale=1.0 / math.sqrt(9 * ci))

        h = rnd(b, res, res, ch, scale=0.8, shift=0.2)
        hstats = fnc._out_stats_plain(h)
        gamma, beta = fold(ch)
        w, bias = conv_w(ch, ch), rnd(ch, scale=0.3)
        res_id = rnd(b, res, res, ch)
        k2("identity (block tail), chained stats", h, gamma, beta, w, bias,
           residual=res_id, stats=hstats)
        k2("identity + own stats pass + emit_stats", h, gamma, beta, w, bias,
           residual=res_id, emit_stats=True)
        k2("identity_up", h, gamma, beta, w, bias,
           residual=rnd(b, res // 2, res // 2, ch), res_up=True, emit_stats=True)
        xc = rnd(b, res, res, 2 * ch, scale=0.8, shift=0.2)
        gc, bc = fold(2 * ch)
        k2("proj from 128-channel concat (conv0 + tail)", h, gamma, beta, w, bias,
           residual=xc, skip_w=rnd(2 * ch, ch, scale=1.0 / math.sqrt(2 * ch)),
           skip_b=rnd(ch, scale=0.3), emit_stats=True)
        k2("128-channel input, emit_stats (decoder conv0)", xc, gc, bc,
           conv_w(2 * ch, ch), bias, emit_stats=True)
        k2("act=False (down-block conv0 at res/2)",
           rnd(b, res // 2, res // 2, ch, scale=0.8, shift=0.2), None, None,
           conv_w(ch, ch), bias)

        # the narrow kernel: K2's linear mode at C <= 8 or O <= 8, beside the
        # route it replaced (gnsc_kernel) and conv2d on the same operands
        def narrow(mode, x, w, bias, emit_stats=False):
            got = fnc.gn_silu_conv(x, None, None, w, bias, emit_stats=emit_stats)
            want = fnc.narrow_conv_plain(x, w, bias, emit_stats)
            b_, h_, w_, c_ = x.shape
            check("K2 narrow_conv", mode, got, want,
                  lambda: fnc.gn_silu_conv(x, None, None, w, bias, emit_stats=emit_stats),
                  lambda: fnc.narrow_conv_plain(x, w, bias, emit_stats),
                  work=(nbytes(x, w, bias, *flat(want)),
                        conv_flops(b_, h_, w_, c_, w.shape[-1])),
                  lib_fn=lambda: conv2d_library(x, w, bias),
                  old_fn=lambda: fnc._gn_silu_conv_kernel(
                      x, None, None, w, bias, 0, 1e-5, None, None, False, None,
                      None, emit_stats)[0])

        narrow("out conv, C 64 -> O 2", h, conv_w(ch, 2), rnd(2, scale=0.3))
        narrow("conv_in, C 4 -> O 64, emit_stats", rnd(b, res, res, 4),
               conv_w(4, ch), bias, emit_stats=True)
        narrow("conv_in, C 2 -> O 64, emit_stats (adm_edm_cond_h)",
               rnd(b, res, res, 2), conv_w(2, ch), bias, emit_stats=True)
        narrow("out conv, C 64 -> O 1 (adm_edm_cond_h)", h, conv_w(ch, 1),
               rnd(1, scale=0.3))

        # K3: decoder up-block conv0, (B, res/2, res/2, C) -> (B, res, res, C)
        xl = rnd(b, res // 2, res // 2, ch, scale=0.8, shift=0.2)
        xl_stats = fnc._out_stats_plain(xl)
        gr = adm_groups(ch)
        got = fnc.gn_silu_up_conv(xl, gamma, beta, w, bias, gr, stats=xl_stats,
                                  emit_stats=True)
        want = fnc.gn_silu_up_conv_plain(xl, gamma, beta, w, bias, gr, emit_stats=True)
        check("K3 gn_silu_up_conv", "up block conv0, chained stats + emit_stats",
              got, want,
              lambda: fnc.gn_silu_up_conv(xl, gamma, beta, w, bias, gr,
                                          stats=xl_stats, emit_stats=True),
              lambda: fnc.gn_silu_up_conv_plain(xl, gamma, beta, w, bias, gr,
                                                emit_stats=True),
              work=(nbytes(xl, gamma, beta, w, bias, *xl_stats, *flat(want)),
                    conv_flops(b, res, res, ch, ch), 3))

        # K4 at the 32x32 attention sites: (B * heads, 1024, 64)
        L = (res // 4) ** 2
        q, k, v = (rnd(b, L, 64) for _ in range(3))
        want = fa.attention_plain(q, k, v)
        check("K4 attention", "(N, L, D)", fa.attention(q, k, v), want,
              lambda: fa.attention(q, k, v), lambda: fa.attention_plain(q, k, v),
              work=(nbytes(q, k, v, want), 4.0 * b * L * L * 64, 3))
        # the kernel called directly, without the autograd Function around it
        lse = torch.empty(b, L, device=device)
        results["K4 attention"]["kernel_call_ms"] = cuda_ms(
            lambda: fa.attention_fwd(q, k, v, lse))
        lib = sdpa_forward(q, k, v, want)
        results["K4 attention"]["library_ms"] = lib["ms"]
        emit({"phase": "kernel", "kernel": "K4 attention", "library": lib})
    return results


def keep_result(results: dict, rec: dict) -> None:
    """Per kernel: the largest error over its modes, with the time, bound and
    library time of its first (summary) mode."""
    prev = results.get(rec["kernel"])
    if prev is None:
        results[rec["kernel"]] = dict(rec)
    elif rec["max_rel_err"] > prev["max_rel_err"]:
        for k in ("max_abs_err", "max_rel_err", "tol"):
            prev[k] = rec[k]


# K1 channel_stats' modes: the main path's two shapes, then res 128 as context
STATS_MODES = ("(B, 1024, 64): the 32x32 sites", "(B, 1024, 128): the decoder's 32x32 concat",
               "(B, N, C) at res 128 (context: not on the main path)")


def x_stats(b: int, res: int, c: int, gen, device, dtype=None):
    """An input of K1's statistics pass at the 32 x 32 sites: (B, (res / 4)^2, c)."""
    import torch

    x = torch.randn(b, (res // 4) ** 2, c, generator=gen, device=device) * 0.8 + 0.2
    return x if dtype is None else x.to(dtype)


def _sdpa():
    """scaled_dot_product_attention pinned to its memory-efficient backend,
    which takes fp32 at D = 64 (the flash backend takes only fp16 / bf16)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call(q, k, v):  # (N, L, D) as (N, 1, L, D)
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q[:, None], k[:, None],
                                                  v[:, None])[:, 0]
    return call, "EFFICIENT_ATTENTION"


def sdpa_forward(q, k, v, want) -> dict:
    """The library call that computes K4's function, timed as the kernels
    are; the port never calls it."""
    call, backend = _sdpa()
    err = compare(call(q, k, v), want, TOL_KERNEL, "sdpa forward")
    return {"call": "torch.nn.functional.scaled_dot_product_attention",
            "backend": backend, "ms": cuda_ms(lambda: call(q, k, v)), **err}


def phase_backward(device, b: int, res: int, ch: int) -> dict:
    """Every backward kernel against autograd of its plain forward (TF32
    off), at the shapes the flagship train step gives it; returns per-kernel
    summaries. Times are of the backward alone: autograd.grad over a kept
    graph, kernel path vs plain path."""
    import torch

    from m_cedm_tpu_torch.kernels import fused_attention as fa
    from m_cedm_tpu_torch.kernels import fused_norm as fn
    from m_cedm_tpu_torch.kernels import fused_norm_conv as fnc
    from m_cedm_tpu_torch.models.layers import adm_groups

    g = torch.Generator(device=device).manual_seed(SEED + 5)

    def rnd(*shape, scale=1.0, shift=0.0, grad=True):
        t = torch.randn(shape, generator=g, device=device) * scale + shift
        return t.requires_grad_(grad)

    def fold(c):
        return rnd(b, c, scale=0.3, shift=1.0), rnd(b, c, scale=0.3)

    results = {}

    def check(kernel, mode, kernel_fn, plain_fn, inputs, work=None, lib_fn=None,
              extra=None):
        """kernel_fn / plain_fn map the inputs to the output whose cotangent
        is a seeded normal. Every input's gradient is held to autograd of the
        plain forward in float64 on the same inputs (the fp32 plain path's
        own error against it is reported beside the kernel's); the times are
        of the fp32 backward on each path. `lib_fn`, a PyTorch call computing
        the same forward, has its backward timed beside (its error recorded,
        not held). `extra()` returns more timings for the record."""
        inputs = list(inputs)
        want_inputs = [t for t in inputs if t is not None and t.requires_grad]
        k_out, p_out = kernel_fn(*inputs), plain_fn(*inputs)
        cot = torch.randn(p_out.shape, generator=g, device=device)

        def grads(out, wrt=want_inputs, c=cot):
            return torch.autograd.grad(out, wrt, c, retain_graph=True)

        in64 = [None if t is None else t.detach().double().requires_grad_(t.requires_grad)
                for t in inputs]
        want = grads(plain_fn(*in64), [t for t in in64 if t is not None and t.requires_grad],
                     cot.double())
        errs = [compare(a, w, TOL_BWD, f"{kernel} {mode} gradient {i}")
                for i, (a, w) in enumerate(zip(grads(k_out), want, strict=True))]
        plain_errs = [compare(a, w, 1.0, f"{kernel} {mode} plain gradient {i}")
                      for i, (a, w) in enumerate(zip(grads(p_out), want, strict=True))]
        rec = {"phase": "backward", "kernel": kernel, "mode": mode,
               **max(errs, key=lambda e: e["max_rel_err"]),
               "gradients": errs,
               "plain_fp32_max_rel_err": max(e["max_rel_err"] for e in plain_errs),
               "ms": cuda_ms(lambda: grads(k_out)),
               "plain_ms": cuda_ms(lambda: grads(p_out))}
        if work is not None:
            rec.update(bound(*work), library_ms=None)
        if lib_fn is not None:
            l_out = lib_fn(*inputs)
            rec["library_ms"] = cuda_ms(lambda: grads(l_out))
            rec["library_max_rel_err"] = max(
                compare(a, w, 1.0, f"{kernel} {mode} library gradient {i}")["max_rel_err"]
                for i, (a, w) in enumerate(zip(grads(l_out), want, strict=True)))
        if extra is not None:
            rec.update(extra())
        emit(rec)
        keep_result(results, rec)
        if lib_fn is not None:
            results[kernel].setdefault("act_false_modes", []).append(
                {k: rec[k] for k in ACT_FALSE_KEYS if k in rec})
        return rec

    def k1_bwd_calls(x, gamma, beta, stats):
        """K1's backward kernel called directly (no autograd), twice for the
        same bits; and, as labelled context (not the same function: it has
        no SiLU derivative and one gamma for the batch), ATen's GroupNorm
        backward on the precomputed cotangent of the affine output, dy *
        gamma, in NCHW, with its dx held to the kernel's."""
        with torch.no_grad():
            xd, gd, bd = x.detach(), gamma.detach(), beta.detach()
            bb, n, c = xd.shape
            cot = torch.randn(xd.shape, generator=g, device=device)
            once = fn.gn_silu_bwd(cot, xd, gd, bd, stats, gr)
            again = fn.gn_silu_bwd(cot, xd, gd, bd, stats, gr)
            if not all(torch.equal(a, a2) for a, a2 in zip(once, again, strict=True)):
                raise AssertionError("K1 backward: two calls gave different bits")
            rec = {"kernel_call_ms": cuda_ms(
                lambda: fn.gn_silu_bwd(cot, xd, gd, bd, stats, gr)), "same_bits": True}
            mean, rstd = fn.group_mean_rstd(xd, gr, 1e-5)
            xhat = (xd - mean[:, None]) * rstd[:, None]
            da = cot * fn.silu_grad(xhat * gd[:, None] + bd[:, None]) * gd[:, None]
            da_t, x_t = (t.transpose(1, 2).contiguous() for t in (da, xd))
            mean_g = mean.reshape(bb, gr, -1)[..., 0].contiguous()
            rstd_g = rstd.reshape(bb, gr, -1)[..., 0].contiguous()
            ones = torch.ones(c, device=device)

            def context():
                return torch.ops.aten.native_group_norm_backward(
                    da_t, x_t, mean_g, rstd_g, ones, bb, c, n, gr, [True, True, True])
            rec["context_ms"] = cuda_ms(context)
            rec["context"] = ("torch.ops.aten.native_group_norm_backward on dy * gamma "
                              "(NCHW; no SiLU derivative, one gamma for the batch)")
            rec["context_dx_max_rel_err"] = compare(
                context()[0].transpose(1, 2), once[0], 1.0, "K1 backward context dx")[
                    "max_rel_err"]
        return rec

    # K1 backward: the down blocks' norm0 at res and res/2, the out-head
    # norm at res; (B, N, C)
    gr = adm_groups(ch)
    for r in (res, res // 2):
        x = rnd(b, r * r, ch, scale=0.8, shift=0.2)
        gamma, beta = fold(ch)
        with torch.no_grad():
            stats = fn.channel_stats_plain(x)
        rec = check("K1 gn_silu_bwd", f"chained stats, res {r}",
                    lambda *a, st=stats: fn.gn_silu(*a, gr, stats=st),
                    lambda *a: fn.gn_silu_plain(*a, gr), (x, gamma, beta),
                    work=(nbytes(x, x, x, gamma, beta, *stats, gamma, beta),
                          20.0 * x.numel()),
                    extra=lambda x=x, gamma=gamma, beta=beta, st=stats: k1_bwd_calls(
                        x, gamma, beta, st))
        if r != res:
            results["K1 gn_silu_bwd"]["at_res_64"] = {
                k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "max_rel_err",
                                    "kernel_call_ms", "context_ms")}

    # K2 backward, every mode of the train step at its flagship shape
    def conv_w(ci, co):
        return rnd(3, 3, ci, co, scale=1.0 / math.sqrt(9 * ci))

    def k2(mode, x, gamma, beta, w, bias, stats=None, kernel="K2 gn_silu_conv_bwd",
           **kw):
        act = gamma is not None
        groups = adm_groups(x.shape[-1]) if act else 0
        names = [k for k, v in kw.items() if torch.is_tensor(v)]
        fixed = {k: v for k, v in kw.items() if k not in names}

        def run(f, st):
            def call(x, gamma, beta, w, bias, *rest):
                return f(x, gamma, beta, w, bias, groups, stats=st,
                         **dict(zip(names, rest)), **fixed)
            return call

        def drop_stats(f):
            def plain(*a, stats=None, **k):
                return f(*a, **k)
            return plain

        b_, h_, w_, c_ = x.shape
        o = w.shape[-1]
        need_da = x.requires_grad or act
        outs = [x] if need_da else []
        if act:
            outs += [gamma, beta]
        tc = kernel == "K2 gn_silu_conv_bwd"  # 3xTF32; the narrow backward is fp32
        work = (nbytes(x, gamma, beta, w, *(stats or ()), *[kw[k] for k in names],
                       torch.empty(b_, h_, w_, o, device="meta"), *outs, w, bias),
                conv_flops(b_, h_, w_, c_, o) * (2 if need_da else 1), 3 if tc else 0)
        return check(kernel, mode, run(fnc.gn_silu_conv, stats),
                     run(drop_stats(fnc.gn_silu_conv_plain), None),
                     [x, gamma, beta, w, bias] + [kw[k] for k in names],
                     work=work, lib_fn=None if act else (
                         lambda x, gamma, beta, w, bias: conv2d_library(x, w, bias)),
                     extra=(lambda: bwd_calls(x, gamma, beta, w, bias, stats, groups,
                                              need_da, kw)) if tc else None)

    def conv2d_context(shape, w, bias):
        """conv2d's autograd backward of the conv alone (no norm, SiLU or
        tail) on an input of `shape`: labelled context for the activated
        modes, not the same function."""
        s_ = rnd(*shape)
        out = conv2d_library(s_, w, bias)
        cot = torch.randn(out.shape, generator=g, device=device)
        return cuda_ms(lambda: torch.autograd.grad(out, (s_, w, bias), cot,
                                                   retain_graph=True))

    def bwd_calls(x, gamma, beta, w, bias, stats, groups, need_da, kw, up=False):
        """The backward kernels called directly (no autograd, no dx pass):
        wgrad (and the projection's one-tap wgrad) and dgrad, each with the
        reduce of its partials; for the activated modes conv2d's backward of
        the conv alone beside them."""
        with torch.no_grad():
            xd, wd_ = x.detach(), w.detach()
            act = gamma is not None
            gd, bd = (gamma.detach(), beta.detach()) if act else (None, None)
            st = (stats or fnc._out_stats_plain(xd)) if act else None
            hh, ww = (2 * xd.shape[1], 2 * xd.shape[2]) if up else xd.shape[1:3]
            cot = torch.randn(xd.shape[0], hh, ww, wd_.shape[-1], generator=g,
                              device=device)
            rec = {"wgrad_call_ms": cuda_ms(lambda: fnc._wgrad(
                xd, cot, gd, bd, st, groups, 1e-5, 9, up, True))}
            if need_da:
                mode = (fnc._DGRAD_UP_FOLD if up else
                        fnc._DGRAD_ACT if act else fnc._DGRAD_LINEAR)
                out = cot.new_empty(xd.shape[0], hh, ww // 2 if up else ww, xd.shape[-1])
                rec["dgrad_call_ms"] = cuda_ms(lambda: fnc._dgrad(
                    cot, wd_, None if up else xd, gd, bd, None if up else st, groups,
                    1e-5, mode, out))
            if kw.get("skip_w") is not None:
                res = kw["residual"].detach()
                rec["proj_wgrad_call_ms"] = cuda_ms(lambda: fnc._wgrad(
                    res, cot, None, None, None, 0, 1e-5, 1, False, False))
        if act:
            rec["conv2d_conv_only_bwd_ms"] = conv2d_context(
                (xd.shape[0], hh, ww, xd.shape[-1]), w, bias)
        return rec

    h = rnd(b, res, res, ch, scale=0.8, shift=0.2)
    with torch.no_grad():
        hstats = fnc._out_stats_plain(h)
    gamma, beta = fold(ch)
    w, bias = conv_w(ch, ch), rnd(ch, scale=0.3)
    k2("identity (block tail), chained stats", h, gamma, beta, w, bias,
       stats=hstats, residual=rnd(b, res, res, ch))
    k2("identity, own stats pass", h, gamma, beta, w, bias,
       residual=rnd(b, res, res, ch))
    k2("identity_up", h, gamma, beta, w, bias,
       residual=rnd(b, res // 2, res // 2, ch), res_up=True)
    xc = rnd(b, res, res, 2 * ch, scale=0.8, shift=0.2)
    k2("proj from 128-channel concat (conv1 + tail)", h, gamma, beta, w, bias,
       residual=xc, skip_w=rnd(2 * ch, ch, scale=1.0 / math.sqrt(2 * ch)),
       skip_b=rnd(ch, scale=0.3))
    gc, bc = fold(2 * ch)
    k2("128-channel input (decoder conv0)", xc, gc, bc, conv_w(2 * ch, ch), bias)
    k2("act=False (conv_in, no input gradient)",
       rnd(b, res, res, 4, grad=False), None, None, conv_w(4, ch), bias)
    k2("act=False (down-block conv0 at res/2)",
       rnd(b, res // 2, res // 2, ch, scale=0.8, shift=0.2), None, None,
       conv_w(ch, ch), bias)
    # the narrow backward (the out conv); then called directly beside the
    # route it replaced, K2's dgrad and wgrad kernels, on the same operands
    w_out = conv_w(ch, 2)
    k2("out conv, C 64 -> O 2", h, None, None, w_out, rnd(2, scale=0.3),
       kernel="K2 narrow_conv_bwd")
    with torch.no_grad():
        hd, wd = h.detach(), w_out.detach()
        cot = torch.randn(b, res, res, 2, generator=g, device=device)
        old = fnc.gn_silu_conv_bwd(cot, hd, None, None, wd, None)
        for i, (a, w_) in enumerate(zip(fnc.narrow_conv_bwd(cot, hd, wd),
                                        (old[0], old[3], old[4]), strict=True)):
            compare(a, w_, TOL_BWD, f"narrow backward against the old route, output {i}")
        calls = {"kernel_call_ms": cuda_ms(lambda: fnc.narrow_conv_bwd(cot, hd, wd)),
                 "old_route_call_ms": cuda_ms(
                     lambda: fnc.gn_silu_conv_bwd(cot, hd, None, None, wd, None))}
    results["K2 narrow_conv_bwd"].update(calls)
    results["K2 narrow_conv_bwd"]["act_false_modes"][-1].update(calls)
    emit({"phase": "backward", "kernel": "K2 narrow_conv_bwd", **calls})

    # K3 backward: decoder up-block conv0, (B, res/2, res/2, C) -> (B, res, res, C)
    xl = rnd(b, res // 2, res // 2, ch, scale=0.8, shift=0.2)
    with torch.no_grad():
        xl_stats = fnc._out_stats_plain(xl)
    w, bias = conv_w(ch, ch), rnd(ch, scale=0.3)
    check("K3 gn_silu_up_conv_bwd", "up block conv0, chained stats",
          lambda *a: fnc.gn_silu_up_conv(*a, gr, stats=xl_stats),
          lambda *a: fnc.gn_silu_up_conv_plain(*a, gr),
          (xl, gamma, beta, w, bias),
          work=(nbytes(xl, gamma, beta, w, *xl_stats,
                       torch.empty(b, res, res, ch, device="meta"),
                       xl, gamma, beta, w, bias),
                2 * conv_flops(b, res, res, ch, ch), 3),
          extra=lambda: bwd_calls(xl, gamma, beta, w, bias, xl_stats, gr, True, {},
                                  up=True))

    # K4 backward at the 32x32 attention sites: (B * heads, 1024, 64)
    L = (res // 4) ** 2
    q, k, v = (rnd(b, L, 64) for _ in range(3))
    rec = check("K4 attention_bwd", "(N, L, D)", fa.attention, fa.attention_plain,
                (q, k, v), work=(4 * (8 * b * L * 64 + b * L), 5 * 2.0 * b * L * L * 64, 3))
    call, backend = _sdpa()
    out = call(q, k, v)
    cot = torch.randn(out.shape, generator=g, device=device)
    q64, k64, v64 = (t.detach().double().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(fa.attention_plain(q64, k64, v64), (q64, k64, v64),
                               cot.double())
    got = torch.autograd.grad(out, (q, k, v), cot, retain_graph=True)
    lib = {"call": "torch.nn.functional.scaled_dot_product_attention (backward)",
           "backend": backend,
           "ms": cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), cot,
                                                     retain_graph=True)),
           "max_rel_err": max(compare(a, w_, TOL_BWD, "sdpa backward")["max_rel_err"]
                              for a, w_ in zip(got, want))}
    results["K4 attention_bwd"]["library_ms"] = lib["ms"]
    # the two kernels called directly, without autograd around them
    with torch.no_grad():
        qd, kd, vd = (t.detach() for t in (q, k, v))
        lse = torch.empty(b, L, device=device)
        o = fa.attention_fwd(qd, kd, vd, lse)
        call_ms = cuda_ms(lambda: fa.attention_bwd(cot, qd, kd, vd, o, lse))
    results["K4 attention_bwd"]["kernel_call_ms"] = call_ms
    emit({"phase": "backward", "kernel": "K4 attention_bwd", "library": lib,
          "kernel_ms": rec["ms"], "kernel_call_ms": call_ms})
    return results


def phase_forward(device, hparams, b: int) -> dict:
    import torch

    from m_cedm_tpu_torch.kernels import PLAIN_OPS
    from m_cedm_tpu_torch.models import build_backbone

    kmodel, cfg = build_backbone(hparams)
    pmodel, _ = build_backbone(hparams, PLAIN_OPS)
    params = seeded_params(kmodel, SEED)
    for m in (kmodel, pmodel):
        m.load_state_dict(params)
        m.to(device).eval()
    rs = np.random.RandomState(SEED + 1)
    r = cfg.resolution
    x = torch.from_numpy(rs.randn(b, r, r, cfg.in_channels).astype(np.float32)).to(device)
    cond = torch.from_numpy(rs.randn(b, r, r, cfg.cond_channels).astype(np.float32)).to(device)
    sigma = torch.from_numpy(rs.uniform(-1.5, 1.0, b).astype(np.float32)).to(device)
    with torch.no_grad():
        got = kmodel(x, sigma, cond)
        want = pmodel(x, sigma, cond)
        if tuple(got.shape) != (b, r, r, cfg.out_ch):
            raise AssertionError(f"forward output shape {tuple(got.shape)}")
        rec = {"phase": "forward", "shape": list(got.shape),
               **compare(got, want, TOL_FORWARD, "full forward"),
               "ms": cuda_ms(lambda: kmodel(x, sigma, cond), 5),
               "plain_ms": cuda_ms(lambda: pmodel(x, sigma, cond), 5)}
    emit(rec)
    return params


def run_eval(task, state, batch, mask, device):
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics, hu_mean = task.eval_step(state, batch, gen, mask, split="test",
                                      mask_name="u")
    if device.type == "cuda":
        torch.cuda.synchronize()
    return {k: float(v) for k, v in metrics.items()}, hu_mean, time.perf_counter() - t0


def flagship_eval_data(device, hparams, b: int):
    """The flagship eval's seeded batch, its mask "u" and its norm stats."""
    import torch

    from m_cedm_tpu_torch.data.masks import eval_masks_var

    r = hparams["model"]["resolution"]
    rs = np.random.RandomState(SEED + 3)
    h, tg, xg, u = synthetic_swe_batch(rs, b, r)
    stats = {"input_mean": h.mean(), "input_std": h.std(),
             "target_mean": u.mean(), "target_std": u.std()}
    batch = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                  for a in (h, tg, xg, u))
    mask = torch.from_numpy(eval_masks_var(r, r)["u"]).to(device)
    return batch, mask, stats


def phase_eval(device, hparams, params, b: int):
    """Returns the launches and the kernel path's metrics."""
    import torch

    from m_cedm_tpu_torch import kernels
    from m_cedm_tpu_torch.tasks import build_task

    r = hparams["model"]["resolution"]
    batch, mask, stats = flagship_eval_data(device, hparams, b)
    task = build_task(hparams, device)
    state = task.init_state(None, stats, params=params)
    task.model.calls = 0
    kernels.reset_launches()
    metrics, hu_mean, wall = run_eval(task, state, batch, mask, device)
    launches = kernels.launches()
    calls = task.model.calls

    if tuple(hu_mean.shape) != (b, r, r, 2) or not torch.isfinite(hu_mean).all():
        raise AssertionError(f"eval output {tuple(hu_mean.shape)} not finite")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite metrics {metrics}")
    gt = task.transform.forward(state, batch[0], batch[3])
    known_err = float((hu_mean[..., 0] - gt[..., 0]).abs().max())
    if known_err > TOL_KNOWN:
        raise AssertionError(f"observed channel moved by {known_err}")
    missing = [k for k in FLAGSHIP_KERNELS if launches[k] == 0 and not k.endswith("_bwd")]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    if launches["K4 attention"] != 4 * calls:
        raise AssertionError(f"K4 launched {launches['K4 attention']} times for "
                             f"{calls} U-Net forwards")
    # conv_in and the out conv on the narrow kernel; gnsc_kernel never at
    # C <= 8 or O <= 8 (it would take one of the narrow launches)
    want = {"K2 narrow_conv": NARROW_PER_FORWARD * calls,
            "K2 gn_silu_conv": K2_PER_FORWARD * calls}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"eval of {calls} forwards: K2 launches "
                             f"{ {k: launches[k] for k in want} }, expected {want}")

    ptask = build_task(hparams, device, ops=kernels.PLAIN_OPS)
    pstate = ptask.init_state(None, stats, params=params)
    walls, pwalls = [wall], []
    for i in range(EVAL_RUNS):  # in turns: plain, kernel, plain, ...
        pmetrics, _, pwall = run_eval(ptask, pstate, batch, mask, device)
        pwalls.append(pwall)
        if i + 1 < EVAL_RUNS:
            walls.append(run_eval(task, state, batch, mask, device)[2])
    for k, v in metrics.items():
        if abs(v - pmetrics[k]) > TOL_METRICS * max(1.0, abs(pmetrics[k])):
            raise AssertionError(f"{k}: kernel path {v} vs plain path {pmetrics[k]}")
    n_samples = hparams["sampler"]["n_samples"]
    wall, pwall = float(np.median(walls)), float(np.median(pwalls))
    emit({"phase": "eval", "mask": "u", "batch": b,
          "steps": hparams["sampler"]["timesteps"],
          "S_churn": hparams["sampler"]["S_churn"], "unet_forwards": calls,
          "metrics": metrics, "plain_metrics": pmetrics,
          "metrics_tol": TOL_METRICS, "known_channel_max_err": known_err,
          "launches": launches, "wall_s": walls, "plain_wall_s": pwalls,
          "samples_per_s": b * n_samples / wall,
          "plain_samples_per_s": b * n_samples / pwall})
    return launches, metrics


def train_steps(task, state, batch, device, first: int, n: int):
    """n train steps with seeded generators (step i draws from seed
    SEED + 10 + i, so both paths see the same masks and noise); returns the
    final state, the metrics and the host-clock seconds of each step."""
    import torch

    metrics, walls = [], []
    for i in range(first, first + n):
        gen = torch.Generator(device=device).manual_seed(SEED + 10 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = task.train_step(state, batch, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics, walls


def profile_step(task, state, batch, device, wall_s: float) -> dict:
    """Device time by CUDA kernel over one train step under torch.profiler;
    the idle share is taken against the unprofiled median step wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train_steps(task, state, batch, device, 100, 1)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {"device_busy_ms": busy_us / 1e3,
            "idle_share_vs_unprofiled_wall": 1.0 - busy_us / 1e3 / (wall_s * 1e3),
            "share_by_kernel": {name: us / busy_us for name, us in top}}


def phase_train(device, hparams, params, b: int) -> dict:
    """McedmTask.train_step at full width and depth: kernel path against the
    plain path over TRAIN_STEPS steps from one state, then timing."""
    import torch

    from m_cedm_tpu_torch import kernels
    from m_cedm_tpu_torch.tasks import build_task

    r = hparams["model"]["resolution"]
    lr = hparams["optimization"]["lr"]
    rs = np.random.RandomState(SEED + 4)
    h, tg, xg, u = synthetic_swe_batch(rs, b, r)
    stats = {"input_mean": h.mean(), "input_std": h.std(),
             "target_mean": u.mean(), "target_std": u.std()}
    batch = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                  for a in (h, tg, xg, u))
    ktask = build_task(hparams, device)
    ptask = build_task(hparams, device, ops=kernels.PLAIN_OPS)
    kstate = ktask.init_state(None, stats, params=params)
    pstate = ptask.init_state(None, stats, params=params)

    kernels.reset_launches()
    kfinal, kmetrics, _ = train_steps(ktask, kstate, batch, device, 0, TRAIN_STEPS)
    launches = kernels.launches()
    pfinal, pmetrics, _ = train_steps(ptask, pstate, batch, device, 0, TRAIN_STEPS)

    for step, (km, pm) in enumerate(zip(kmetrics, pmetrics)):
        for key in ("train_loss", "grad_norm"):
            if not math.isfinite(km[key]) or abs(km[key] - pm[key]) > TOL_TRAIN * abs(pm[key]):
                raise AssertionError(f"step {step} {key}: kernel {km[key]} vs plain {pm[key]}")

    def max_diff(a, b_):
        return max(float((a[k] - b_[k]).abs().max()) for k in a)

    tol_params = 2 * lr * TRAIN_STEPS
    diffs = {"params": max_diff(kfinal.params, pfinal.params),
             "ema_params": max_diff(kfinal.ema_params, pfinal.ema_params),
             "adam_mu": max_diff(kfinal.opt_state["mu"], pfinal.opt_state["mu"])}
    moved = max_diff(kfinal.params, kstate.params)
    if not (diffs["params"] <= tol_params and diffs["ema_params"] <= tol_params):
        raise AssertionError(f"params after {TRAIN_STEPS} steps differ: {diffs}")
    if not moved > 0:
        raise AssertionError("the train steps did not move the parameters")
    bwd = [k for k in FLAGSHIP_KERNELS if k.endswith("_bwd")]
    missing = [k for k in FLAGSHIP_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the train steps: {missing}")
    if launches["K4 attention_bwd"] != 4 * TRAIN_STEPS:
        raise AssertionError(f"K4 backward launched {launches['K4 attention_bwd']} "
                             f"times in {TRAIN_STEPS} steps")
    want = {"K2 narrow_conv": NARROW_PER_FORWARD * TRAIN_STEPS,
            "K2 gn_silu_conv": K2_PER_FORWARD * TRAIN_STEPS,
            "K2 narrow_conv_bwd": NARROW_BWD_PER_STEP * TRAIN_STEPS,
            "K2 gn_silu_conv_bwd": K2_BWD_PER_STEP * TRAIN_STEPS,
            "K1 gn_silu_bwd": K1_BWD_PER_STEP * TRAIN_STEPS}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"{TRAIN_STEPS} train steps: K1 / K2 launches "
                             f"{ {k: launches[k] for k in want} }, expected {want}")

    n = TRAIN_WARMUP + TRAIN_TIMED  # in turns: kernel path, then plain path
    _, _, kwalls = train_steps(ktask, kfinal, batch, device, TRAIN_STEPS, n)
    _, _, pwalls = train_steps(ptask, pfinal, batch, device, TRAIN_STEPS, n)
    ms = float(np.median(kwalls[TRAIN_WARMUP:])) * 1e3
    pms = float(np.median(pwalls[TRAIN_WARMUP:])) * 1e3
    prof = profile_step(ktask, kfinal, batch, device, ms / 1e3)
    emit({"phase": "train", "batch": b, "steps": TRAIN_STEPS,
          "train_loss": [m["train_loss"] for m in kmetrics],
          "plain_train_loss": [m["train_loss"] for m in pmetrics],
          "grad_norm": [m["grad_norm"] for m in kmetrics],
          "plain_grad_norm": [m["grad_norm"] for m in pmetrics],
          "tol": TOL_TRAIN, "max_abs_diff": diffs, "tol_params": tol_params,
          "params_moved_max": moved, "launches": launches,
          "launches_per_step": {k: launches[k] / TRAIN_STEPS for k in bwd + [
              "K2 gn_silu_conv", "K2 narrow_conv"]},
          "ms_per_step": ms, "plain_ms_per_step": pms,
          "step_ms": [w * 1e3 for w in kwalls],
          "plain_step_ms": [w * 1e3 for w in pwalls], "profile": prof})
    return launches

LINEAR_KEYS = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "bound_fp32_ms",
               "max_rel_err", "vs_float64_max_rel_err", "backward_max_rel_err",
               "backward_ms", "plain_backward_ms", "backward_library_ms",
               "backward_bound_ms")


def phase_linear_attention(device, b: int, n: int, width: int) -> dict:
    """K5 and K6 at the OFormer's shapes: the encoder and mix layer (BH = B)
    and the cross attention (BH = 4 B). Each forward against its plain
    version; each Function's backward (two kernel launches for K5's, two
    for K6's) against float64 autograd of its plain forward. Returns the
    summaries at BH = B, with the BH = 4 B records beside them."""
    import torch

    from m_cedm_tpu_torch.kernels import linear_attention as la

    g = torch.Generator(device=device).manual_seed(SEED + 6)
    smi = nvidia_smi_line()

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale

    def bwd_library(name, args, cot):
        """The backward's two products through torch.bmm: kv_dots' dk = v
        g^T and dv = k g, apply_dots' dq = g dots^T and ddots = q^T g."""
        a, b_ = args
        if name == "K5 kv_dots":
            return (torch.bmm(b_, cot.transpose(1, 2)), torch.bmm(a, cot))
        return (torch.bmm(cot, b_.transpose(1, 2)), torch.bmm(a.transpose(1, 2), cot))

    def bwd_bound(name, args, cot, flops) -> float:
        """Bytes (the inputs and the cotangent read once, the two gradients
        written once) against the two products' operations in 3xTF32 (three
        TF32 FLOPs per FLOP): K5's backward is two K6 calls, K6's one K6 and
        one K5, all on the tensor cores."""
        t_bytes = nbytes(*args, *args, cot) / PEAK_BYTES * 1e3
        t_ops = 2 * 3 * flops / PEAK_TF32 * 1e3
        return max(t_bytes, t_ops)

    results = {}
    for bh in (b, 4 * b):
        q, k, v = (rnd(bh, n, width) for _ in range(3))
        dots = la.kv_dots_plain(k, v) / n
        cases = (
            ("K5 kv_dots", la.kv_dots, la.kv_dots_plain, (k, v),
             lambda: torch.bmm(k.transpose(1, 2), v), "bnd,bne->bde", 3),
            ("K6 apply_dots", la.apply_dots, la.apply_dots_plain, (q, dots),
             lambda: torch.bmm(q, dots), "bnd,bde->bne", 3),
        )
        for name, fn, plain, args, library, eq, tf32 in cases:
            with torch.no_grad():
                want = plain(*args)
                got = fn(*args)
                want64 = torch.einsum(eq, *(a.double() for a in args))
                rec = {"phase": "linear", "nvidia_smi": smi, "kernel": name, "bh": bh,
                       "n": n, "width": width,
                       **compare(got, want, TOL_KERNEL, f"{name} BH {bh}"),
                       "vs_float64_max_rel_err": compare(got, want64, 1.0, "")["max_rel_err"],
                       "plain_vs_float64_max_rel_err": compare(
                           want, want64, 1.0, "")["max_rel_err"],
                       "library_max_rel_err": compare(library(), want, TOL_KERNEL,
                                                      f"torch.bmm for {name}")["max_rel_err"],
                       "ms": cuda_ms(lambda: fn(*args)),
                       "plain_ms": cuda_ms(lambda: plain(*args)),
                       "library": "torch.bmm", "library_ms": cuda_ms(library),
                       **bound(nbytes(*args, want), 2.0 * bh * n * width * width,
                               tf32)}
                del got, want64
            leaves = [a.detach().clone().requires_grad_() for a in args]
            out = fn(*leaves)
            cot = rnd(*out.shape)
            in64 = [a.detach().double().requires_grad_() for a in args]
            want = torch.autograd.grad(torch.einsum(eq, *in64), in64, cot.double())
            got = torch.autograd.grad(out, leaves, cot, retain_graph=True)
            errs = [compare(a, w, TOL_BWD, f"{name} BH {bh} gradient {i}")
                    for i, (a, w) in enumerate(zip(got, want, strict=True))]
            p_out = plain(*leaves)
            with torch.no_grad():
                lib_err = max(compare(a, w, TOL_BWD, f"torch.bmm backward for {name}")
                              ["max_rel_err"] for a, w in zip(
                                  bwd_library(name, args, cot), want, strict=True))
            rec.update(
                backward_max_rel_err=max(e["max_rel_err"] for e in errs),
                backward_tol=TOL_BWD,
                backward_ms=cuda_ms(lambda: torch.autograd.grad(out, leaves, cot,
                                                                retain_graph=True)),
                plain_backward_ms=cuda_ms(lambda: torch.autograd.grad(
                    p_out, leaves, cot, retain_graph=True)),
                backward_library="torch.bmm (the two products)",
                backward_library_ms=cuda_ms(lambda: bwd_library(name, args, cot)),
                backward_library_max_rel_err=lib_err,
                backward_bound_ms=bwd_bound(name, args, cot,
                                            2.0 * bh * n * width * width))
            del out, p_out, got, want, in64
            emit(rec)
            if bh == b:
                results[name] = dict(rec)
            else:
                results[name][f"at_bh_{bh}"] = {k: rec[k] for k in LINEAR_KEYS
                                                 if k in rec}
            for key in ("max_abs_err", "max_rel_err"):
                results[name][key] = max(results[name][key], rec[key])
        del q, k, v, dots
    torch.cuda.empty_cache()
    return results


def oformer_setup(device, b: int, seed: int, hparams=OFORMER_HPARAMS,
                  target=OFORMER_TARGET):
    """The OFormer's own init drawn from a seeded generator (fan-in-scaled
    lecun-normal dense layers, the orthogonal-plus-diagonal q/k/v blocks,
    the Fourier matrix B; no layer starts at zero, so every kernel's work
    shows), and seeded synthetic shallow-water fields on the 128 x 128 grid,
    tokenized as the OFormer datamodule does (h in, u out), or as the
    time-prediction datamodule does for OformerTimePredTask (both fields,
    the first TIMEPRED_HISTORY steps in, the rest out)."""
    import torch

    from m_cedm_tpu_torch.data.oformer_data import (TIMEPRED_KEYS, TOKEN_KEYS,
                                                    tokenize_grid,
                                                    tokenize_time_pred)
    from m_cedm_tpu_torch.tasks import build_task

    res = hparams["encoder"]["res"]
    h, _, _, u = synthetic_swe_batch(np.random.RandomState(seed), b, res)
    stats = {"input_mean": h.mean(), "input_std": h.std(),
             "target_mean": u.mean(), "target_std": u.std()}
    t = np.broadcast_to(np.linspace(0.0, 1.0, res, dtype=np.float32), (b, res))
    x = np.broadcast_to(np.linspace(-2.5, 2.5, res, dtype=np.float32), (b, res))
    if target == TIMEPRED_TARGET:
        tok, keys = tokenize_time_pred(h, u, x, t, stats, TIMEPRED_HISTORY), TIMEPRED_KEYS
    else:
        tok, keys = tokenize_grid(h, u, x, t, stats), TOKEN_KEYS
    batch = tuple(torch.from_numpy(np.ascontiguousarray(tok[k])).to(device) for k in keys)
    fresh = build_task(hparams, "cpu", target=target).init_state(
        torch.Generator().manual_seed(seed), stats)
    return stats, batch, fresh.params, fresh.constants


def oformer_tasks(device, hparams=OFORMER_HPARAMS, target=OFORMER_TARGET):
    from m_cedm_tpu_torch import kernels
    from m_cedm_tpu_torch.tasks import build_task

    return [build_task(hparams, device, target=target, ops=ops,
                       grad_clip=OFORMER_GRAD_CLIP)
            for ops in (kernels.DEVICE_OPS, kernels.PLAIN_OPS)]


def check_oformer_launches(launches: dict, k5: int, k6: int, what: str) -> None:
    got = (launches["K5 kv_dots"], launches["K6 apply_dots"])
    if got != (k5, k6):
        raise AssertionError(f"{what}: K5, K6 launched {got} times, expected {(k5, k6)}")


def phase_oformer_eval(device, b: int, hparams=OFORMER_HPARAMS, target=OFORMER_TARGET,
                       phase: str = "oformer_eval", seed: int = SEED + 7) -> dict:
    """OformerTask.eval_step (or OformerTimePredTask's) at full width and
    depth on both paths."""
    import torch

    from m_cedm_tpu_torch import kernels

    stats, batch, params, constants = oformer_setup(device, b, seed, hparams, target)
    ktask, ptask = oformer_tasks(device, hparams, target)
    kstate, pstate = (t.init_state(None, stats, params=params, constants=constants)
                      for t in (ktask, ptask))

    def run(task, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics, grid = task.eval_step(state, batch, split="val")
        torch.cuda.synchronize()
        return {k: float(v) for k, v in metrics.items()}, grid, time.perf_counter() - t0

    kernels.reset_launches()
    metrics, grid, wall = run(ktask, kstate)
    launches = kernels.launches()
    check_oformer_launches(launches, OFORMER_SITES, OFORMER_SITES, f"one {phase}")
    want = (b, int(batch[-1][0]), hparams["encoder"]["res"],
            hparams["decoder"]["out_channels"])
    if tuple(grid.shape) != want or not torch.isfinite(grid).all():
        raise AssertionError(f"OFormer prediction {tuple(grid.shape)} not finite or "
                             f"not {want}")
    if len(metrics) != 7 or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"OFormer metrics {metrics}")
    walls, pwalls = [wall], []
    for i in range(EVAL_RUNS):  # in turns: plain, kernel, plain, ...
        pmetrics, pgrid, pwall = run(ptask, pstate)
        pwalls.append(pwall)
        if i + 1 < EVAL_RUNS:
            walls.append(run(ktask, kstate)[2])
    for k, v in metrics.items():
        if abs(v - pmetrics[k]) > TOL_METRICS * max(1.0, abs(pmetrics[k])):
            raise AssertionError(f"OFormer {k}: kernel path {v} vs plain path {pmetrics[k]}")
    emit({"phase": phase, "nvidia_smi": nvidia_smi_line(), "batch": b,
          "tokens": int(batch[0].shape[2]), "prop_tokens": int(batch[1].shape[2]),
          "metrics": metrics, "plain_metrics": pmetrics, "metrics_tol": TOL_METRICS,
          "prediction": compare(grid, pgrid, TOL_FORWARD, "OFormer prediction"),
          "launches": {k: launches[k] for k in OFORMER_KERNELS},
          "wall_s": walls, "plain_wall_s": pwalls,
          "ms_per_eval": float(np.median(walls)) * 1e3,
          "plain_ms_per_eval": float(np.median(pwalls)) * 1e3})
    return launches


def phase_oformer_train(device, b: int, hparams=OFORMER_HPARAMS, target=OFORMER_TARGET,
                        phase: str = "oformer_train", seed: int = SEED + 8,
                        trajectory_tol: float = TOL_TRAIN) -> dict:
    """Three OformerTask.train_steps (or OformerTimePredTask's) from one
    state on both paths, then timing, one profiled step and the peak memory
    of a step. Each step is also held alone, in both directions: a
    kernel-path step from each of the plain path's states, and a plain-path
    step from each of the kernel path's. Returns the launches per step and
    the kernel path's state after the three steps."""
    import torch

    from m_cedm_tpu_torch import kernels

    stats, batch, params, constants = oformer_setup(device, b, seed, hparams, target)
    ktask, ptask = oformer_tasks(device, hparams, target)
    kstate, pstate = (t.init_state(None, stats, params=params, constants=constants)
                      for t in (ktask, ptask))

    def trajectory(task, state):
        """The steps one at a time, keeping every state."""
        states, metrics = [state], []
        for i in range(TRAIN_STEPS):
            st, m, _ = train_steps(task, states[-1], batch, device, i, 1)
            states.append(st)
            metrics += m
        return states, metrics

    kernels.reset_launches()
    kstates, kmetrics = trajectory(ktask, kstate)
    launches = kernels.launches()
    check_oformer_launches(launches, 2 * OFORMER_SITES * TRAIN_STEPS,
                           4 * OFORMER_SITES * TRAIN_STEPS,
                           f"{TRAIN_STEPS} OFormer train steps")
    pstates, pmetrics = trajectory(ptask, pstate)
    kfinal, pfinal = kstates[-1], pstates[-1]

    def hold(got, want, tol, what):
        for step, (km, pm) in enumerate(zip(got, want, strict=True)):
            for key in ("train_loss", "grad_norm"):
                if not math.isfinite(km[key]) or abs(km[key] - pm[key]) > tol * abs(pm[key]):
                    raise AssertionError(f"OFormer {what} step {step} {key}: kernel "
                                         f"{km[key]} vs plain {pm[key]}")

    # each step alone, without the growth of a rounding difference along the
    # trajectory (the gradient norm grows about sevenfold a step): a kernel
    # step from each of the plain path's states, a plain step from each of
    # the kernel path's
    step_metrics = [train_steps(ktask, pstates[i], batch, device, i, 1)[1][0]
                    for i in range(TRAIN_STEPS)]
    cross_metrics = [train_steps(ptask, kstates[i], batch, device, i, 1)[1][0]
                     for i in range(TRAIN_STEPS)]
    hold(step_metrics, pmetrics, TOL_TRAIN, "per-step")
    hold(kmetrics, cross_metrics, TOL_TRAIN, "per-step from the kernel path's states")
    hold(kmetrics, pmetrics, trajectory_tol, "trajectory")
    lr = hparams["lr"]
    diff = max(float((kfinal.params[k] - pfinal.params[k]).abs().max()) for k in kfinal.params)
    moved = max(float((kfinal.params[k] - kstate.params[k]).abs().max()) for k in kfinal.params)
    if not (diff <= 2 * lr * TRAIN_STEPS and moved > 0):
        raise AssertionError(f"OFormer params after {TRAIN_STEPS} steps: differ by "
                             f"{diff}, moved {moved}")

    n = TRAIN_WARMUP + TRAIN_TIMED  # in turns: kernel path, then plain path
    _, _, kwalls = train_steps(ktask, kfinal, batch, device, TRAIN_STEPS, n)
    _, _, pwalls = train_steps(ptask, pfinal, batch, device, TRAIN_STEPS, n)
    ms = float(np.median(kwalls[TRAIN_WARMUP:])) * 1e3
    pms = float(np.median(pwalls[TRAIN_WARMUP:])) * 1e3
    torch.cuda.reset_peak_memory_stats()
    train_steps(ktask, kfinal, batch, device, 50, 1)
    peak = torch.cuda.max_memory_allocated()
    prof = profile_step(ktask, kfinal, batch, device, ms / 1e3)
    emit({"phase": phase, "nvidia_smi": nvidia_smi_line(), "batch": b, "steps": TRAIN_STEPS,
          "train_loss": [m["train_loss"] for m in kmetrics],
          "plain_train_loss": [m["train_loss"] for m in pmetrics],
          "grad_norm": [m["grad_norm"] for m in kmetrics],
          "plain_grad_norm": [m["grad_norm"] for m in pmetrics],
          "per_step_train_loss": [m["train_loss"] for m in step_metrics],
          "per_step_grad_norm": [m["grad_norm"] for m in step_metrics],
          "plain_from_kernel_states_grad_norm": [m["grad_norm"] for m in cross_metrics],
          "tol": TOL_TRAIN, "trajectory_tol": trajectory_tol, "params_max_abs_diff": diff,
          "tol_params": 2 * lr * TRAIN_STEPS, "params_moved_max": moved,
          "launches_per_step": {k: launches[k] / TRAIN_STEPS for k in OFORMER_KERNELS},
          "ms_per_step": ms, "plain_ms_per_step": pms,
          "step_ms": [w * 1e3 for w in kwalls],
          "plain_step_ms": [w * 1e3 for w in pwalls],
          "peak_memory_gib": peak / 2 ** 30, "profile": prof})
    return {k: launches[k] // TRAIN_STEPS for k in OFORMER_KERNELS}, kfinal


def two_kernel_block(x, g0, b0, w0, bias0, g1, b1, w1, bias1, groups0, groups1,
                     eps, *, x2=None, skip_w=None, skip_b=None, stats=None,
                     emit_stats=False, up=False):
    """The U-Net's per-conv path for one block (mega=False): K2 conv0 (or K3
    for an up block) emitting its statistics, then the K2 tail; a decoder's
    concat is made first. The yardstick K7 replaces."""
    from m_cedm_tpu_torch.kernels import fused_block as fb
    from m_cedm_tpu_torch.kernels import fused_norm_conv as fnc

    return fb._composition(fnc.gn_silu_conv, fnc.gn_silu_up_conv, x, g0, b0, w0, bias0,
                           g1, b1, w1, bias1, groups0, groups1, eps, x2, skip_w, skip_b,
                           emit_stats, up, stats=stats, chain=True)


def phase_mega_kernel(device, b: int, res: int, ch: int) -> dict:
    """K7 against its plain version, one case per variant the U-Net runs at
    the flagship's shapes and the ragged case of the CUDA tests; kernel,
    plain and two-kernel-path times; the recompute backward against float64
    autograd of the plain composition. Returns the identity case's summary."""
    import torch

    from m_cedm_tpu_torch.kernels import _build
    from m_cedm_tpu_torch.kernels import fused_block as fb
    from m_cedm_tpu_torch.models.layers import adm_groups

    g = torch.Generator(device=device).manual_seed(SEED + 9)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=g, device=device) * scale + shift

    def block(bb, h, w, c1, c2, o, up=False, proj=False, chained=False, emit=False):
        c = c1 + c2
        args = [rnd(bb, h, w, c1, scale=0.8, shift=0.2), rnd(bb, c, scale=0.3, shift=1.0),
                rnd(bb, c, scale=0.3), rnd(3, 3, c, o, scale=1.0 / math.sqrt(9 * c)),
                rnd(o, scale=0.3), rnd(bb, o, scale=0.3, shift=1.0), rnd(bb, o, scale=0.3),
                rnd(3, 3, o, o, scale=1.0 / math.sqrt(9 * o)), rnd(o, scale=0.3),
                adm_groups(c), adm_groups(o), 1e-5]
        kw = dict(emit_stats=emit, up=up)
        if c2:
            kw["x2"] = rnd(bb, h, w, c2, scale=0.8, shift=0.2)
        if proj:
            kw["skip_w"] = rnd(c, o, scale=1.0 / math.sqrt(c))
            kw["skip_b"] = rnd(o, scale=0.3)
        if chained:
            xin = torch.cat([args[0]] + ([kw["x2"]] if c2 else []), -1)
            kw["stats"] = (xin.sum(dim=(1, 2)), (xin * xin).sum(dim=(1, 2)))
        return args, kw

    lo = res // 2
    cases = (
        (f"identity, res {res}, chained stats, emit",
         block(b, res, res, ch, 0, ch, chained=True, emit=True)),
        (f"dual + 1x1 projection ({ch} + {ch} -> {ch}), res {res}, own stats pass",
         block(b, res, res, ch, ch, ch, proj=True)),
        (f"up, identity ({lo}x{lo} -> {res}x{res}), chained stats, emit",
         block(b, lo, lo, ch, 0, ch, up=True, chained=True, emit=True)),
        # tests/test_torch_cuda.py K7_CASES["wide-two-out-tiles"]
        ("ragged: (1, 7, 19), 128 + 128 -> 128, projection, chained, emit",
         block(1, 7, 19, 128, 128, 128, proj=True, chained=True, emit=True)),
    )
    first = None
    for mode, (args, kw) in cases:
        with torch.no_grad():
            want = fb.fused_unet_block_plain(*args, **{k: v for k, v in kw.items()
                                                       if k != "stats"})
            got = fb.fused_unet_block(*args, **kw)
            flat_got = [got] if not kw["emit_stats"] else [got[0], *got[1]]
            flat_want = [want] if not kw["emit_stats"] else [want[0], *want[1]]
            errs = [compare(a, w, TOL_MEGA, f"K7 {mode} output {i}")
                    for i, (a, w) in enumerate(zip(flat_got, flat_want, strict=True))]
            two = two_kernel_block(*args, **kw)
            flat_two = [two] if not kw["emit_stats"] else [two[0], *two[1]]
            two_err = max(compare(a, w, TOL_MEGA, f"two-kernel path {mode} output {i}")
                          ["max_rel_err"]
                          for i, (a, w) in enumerate(zip(flat_two, flat_want, strict=True)))
            bb, hh, ww, c1 = args[0].shape
            hh, ww = (2 * hh, 2 * ww) if kw["up"] else (hh, ww)
            c, o = args[3].shape[2], args[3].shape[3]
            flops = (conv_flops(bb, hh, ww, c, o) + conv_flops(bb, hh, ww, o, o)
                     + (2.0 * bb * hh * ww * c * o if "skip_w" in kw else 0.0))
            tensors = [a for a in args if torch.is_tensor(a)] + [
                kw.get(k) for k in ("x2", "skip_w", "skip_b")] + list(
                kw.get("stats") or ()) + flat_want
            plain_kw = {k: v for k, v in kw.items() if k != "stats"}
            rec = {"phase": "mega_kernel", "kernel": "K7 unet_block", "mode": mode,
                   **max(errs, key=lambda e: e["max_rel_err"]),
                   "outputs_checked": len(errs),
                   "two_kernel_path_max_rel_err": two_err,
                   "ms": cuda_ms(lambda: fb.fused_unet_block(*args, **kw)),
                   "plain_ms": cuda_ms(lambda: fb.fused_unet_block_plain(*args, **plain_kw)),
                   "two_kernel_ms": cuda_ms(lambda: two_kernel_block(*args, **kw)),
                   **bound(nbytes(*tensors), flops, tf32_products=3), "library_ms": None,
                   "library": "none: no PyTorch call computes a whole ADM block"}
            items, blocks = fb.grid(bb, hh, ww, o, kw["up"])
            rec.update(occupancy_blocks_per_sm_x_sms=fb.occupancy(kw["up"]),
                       items=items, grid=blocks)
        if first is None:
            # ptxas's registers and spills of unet_block_kernel<false> and <true>
            rec["ptxas"] = [ln.strip() for ln in _build.build_log("fused_block").splitlines()
                            if any(k in ln for k in ("unet_block_kernel", "registers",
                                                     "spill"))]
            first = rec
        emit(rec)
        for k in ("max_abs_err", "max_rel_err"):
            first[k] = max(first[k], rec[k])
        if mode.startswith("dual"):
            rec_bwd = mega_backward(device, g, args, kw)
            emit(rec_bwd)
            first["backward_max_rel_err"] = rec_bwd["max_rel_err"]
        del want, got, two
    torch.cuda.empty_cache()
    return {"K7 unet_block": first}


def mega_backward(device, g, args, kw) -> dict:
    """K7 called under grad mode: its Function's recompute backward (K2's
    backward kernels) against float64 autograd of the plain composition, on
    the first two samples of the case."""
    import torch

    from m_cedm_tpu_torch import kernels
    from m_cedm_tpu_torch.kernels import fused_block as fb

    names = [k for k in ("x2", "skip_w", "skip_b") if k in kw]
    # x, g0, b0, g1 and b1 are per sample
    cut = [a[:2] if i in (0, 1, 2, 5, 6) else a for i, a in enumerate(args)]
    kw = dict(kw, **{k: kw[k][:2] for k in ("x2",) if k in kw})
    kw.pop("stats", None)
    tensors = [a for a in cut if torch.is_tensor(a)] + [kw[k] for k in names]
    leaves = [t.detach().clone().requires_grad_() for t in tensors]

    def call(fn, ts):
        it = iter(ts)
        a = [next(it) if torch.is_tensor(x) else x for x in cut]
        out = fn(*a, **dict(kw, **dict(zip(names, it))))
        return out[0] if kw["emit_stats"] else out

    kernels.reset_launches()
    out = call(fb.fused_unet_block, leaves)
    cot = torch.randn(out.shape, generator=g, device=device)
    got = torch.autograd.grad(out, leaves, cot)
    launches = kernels.launches()
    l64 = [t.detach().double().requires_grad_() for t in tensors]
    want = torch.autograd.grad(call(fb.fused_unet_block_plain, l64), l64, cot.double())
    errs = [compare(a, w, TOL_BWD, f"K7 recompute backward gradient {i}")
            for i, (a, w) in enumerate(zip(got, want, strict=True))]
    if launches["K7 unet_block"] != 1 or launches["K2 gn_silu_conv_bwd"] < 1:
        raise AssertionError(f"K7 under grad mode launched {launches}")
    return {"phase": "mega_kernel", "kernel": "K7 unet_block (recompute backward)",
            "batch": int(out.shape[0]), **max(errs, key=lambda e: e["max_rel_err"]),
            "gradients": errs,
            "launches": {k: v for k, v in launches.items() if v}}


def check_mega_launches(launches: dict, forwards: int, what: str) -> None:
    want = {k: n * forwards for k, n in MEGA_LAUNCHES.items()}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: launched {got}, expected {want}")


def phase_mega_eval(device, hparams, params, b: int, eval_metrics: dict) -> dict:
    """The flagship eval of phase 4 (same state, same noise) with mega=True:
    metrics against the per-conv kernel path of phase 4, the launch counts,
    and samples/s of both paths taken in turns."""
    import torch

    from m_cedm_tpu_torch import kernels
    from m_cedm_tpu_torch.tasks import build_task

    batch, mask, stats = flagship_eval_data(device, hparams, b)
    task = build_task(hparams, device, mega=True)
    state = task.init_state(None, stats, params=params)
    task.model.calls = 0
    kernels.reset_launches()
    metrics, hu_mean, wall = run_eval(task, state, batch, mask, device)
    launches = kernels.launches()
    calls = task.model.calls
    check_mega_launches(launches, calls, f"mega flagship eval ({calls} forwards)")
    gt = task.transform.forward(state, batch[0], batch[3])
    known_err = float((hu_mean[..., 0] - gt[..., 0]).abs().max())
    if known_err > TOL_KNOWN or not torch.isfinite(hu_mean).all():
        raise AssertionError(f"mega eval: observed channel moved by {known_err}")
    for k, v in metrics.items():
        if not math.isfinite(v) or abs(v - eval_metrics[k]) > TOL_METRICS * max(
                1.0, abs(eval_metrics[k])):
            raise AssertionError(f"mega eval {k}: {v} vs per-conv path {eval_metrics[k]}")
    ptask = build_task(hparams, device)
    pstate = ptask.init_state(None, stats, params=params)
    walls, pwalls = [wall], []
    for _ in range(MEGA_RUNS):  # in turns: per-conv, mega, per-conv, mega
        pwalls.append(run_eval(ptask, pstate, batch, mask, device)[2])
        walls.append(run_eval(task, state, batch, mask, device)[2])
    n = b * hparams["sampler"]["n_samples"]
    wall, pwall = float(np.median(walls[1:])), float(np.median(pwalls))
    emit({"phase": "mega_eval", "batch": b, "unet_forwards": calls,
          "metrics": metrics, "per_conv_metrics": eval_metrics,
          "metrics_tol": TOL_METRICS, "known_channel_max_err": known_err,
          "launches": {k: v for k, v in launches.items() if v},
          "launches_per_forward": {k: launches[k] / calls for k in MEGA_LAUNCHES},
          "wall_s": walls, "per_conv_wall_s": pwalls,
          "samples_per_s": n / wall, "per_conv_samples_per_s": n / pwall})
    return launches


def phase_cond_edm(device, b: int) -> dict:
    """CondEdmTask (configs/model/adm_edm_cond_h_res32.yaml) at full width
    and depth: one eval_step on the kernel path with mega=True and one on the
    plain path, the same seeded weights and noise; metrics, launches and
    samples/s of both, taken in turns."""
    import torch

    from m_cedm_tpu_torch import kernels
    from m_cedm_tpu_torch.tasks import build_task

    hp = COND_EDM_HPARAMS
    r = hp["model"]["resolution"]
    h, tg, xg, u = synthetic_swe_batch(np.random.RandomState(SEED + 11), b, r)
    stats = {"input_mean": h.mean(), "input_std": h.std(),
             "target_mean": u.mean(), "target_std": u.std()}
    batch = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                  for a in (h, tg, xg, u))
    tasks = [build_task(hp, device, target=COND_EDM_TARGET, ops=ops, mega=True)
             for ops in (kernels.DEVICE_OPS, kernels.PLAIN_OPS)]
    params = seeded_params(tasks[0].model, SEED + 12)
    states = [t.init_state(None, stats, params=params) for t in tasks]

    def run(i):
        gen = torch.Generator(device=device).manual_seed(SEED + 13)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics, u_mean = tasks[i].eval_step(states[i], batch, gen, split="test")
        torch.cuda.synchronize()
        return ({k: float(v) for k, v in metrics.items()}, u_mean,
                time.perf_counter() - t0)

    tasks[0].model.calls = 0
    kernels.reset_launches()
    metrics, u_mean, wall = run(0)
    launches = kernels.launches()
    calls = tasks[0].model.calls
    check_mega_launches(launches, calls, f"CondEdmTask eval ({calls} forwards)")
    if tuple(u_mean.shape) != (b, r, r, 1) or not torch.isfinite(u_mean).all():
        raise AssertionError(f"CondEdmTask sample {tuple(u_mean.shape)} not finite")
    want = {"test_mae_u", "test_mae_u_un", "test_mae_u_scaled", "test_corr_u",
            "test_pde_loss", "test_pde_loss_gt"}
    if set(metrics) != want or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"CondEdmTask metrics {metrics}")
    walls, pwalls = [wall], []
    for _ in range(MEGA_RUNS):  # in turns: plain, kernel, plain, kernel
        pmetrics, pu_mean, pwall = run(1)
        pwalls.append(pwall)
        walls.append(run(0)[2])
    for k, v in metrics.items():
        if abs(v - pmetrics[k]) > TOL_METRICS * max(1.0, abs(pmetrics[k])):
            raise AssertionError(f"CondEdmTask {k}: kernel path {v} vs plain {pmetrics[k]}")
    n = b * hp["sampler"]["n_samples"]
    wall, pwall = float(np.median(walls[1:])), float(np.median(pwalls))
    emit({"phase": "cond_edm_eval", "config": "adm_edm_cond_h", "batch": b,
          "steps": hp["sampler"]["timesteps"], "S_churn": hp["sampler"]["S_churn"],
          "unet_forwards": calls, "metrics": metrics, "plain_metrics": pmetrics,
          "metrics_tol": TOL_METRICS,
          "sample": compare(u_mean, pu_mean, TOL_METRICS, "CondEdmTask sample"),
          "launches": {k: v for k, v in launches.items() if v},
          "wall_s": walls, "plain_wall_s": pwalls,
          "samples_per_s": n / wall, "plain_samples_per_s": n / pwall})
    return launches


# ---------------------------------------------------------------------------
# phase 12: the CLI
# ---------------------------------------------------------------------------

CLI_CONFIG = "config_adm_edm_mcedm_res32.yaml"
CLI_TRAIN, CLI_TEST = 64, 16  # trajectories at res 128 (T = X = 128)
# The metric keys of the flagship's metrics.jsonl, as the JAX package's
# run.main writes them, written down from one JAX run with
# trainer.max_epochs=1 on tests/test_cli.py's fixtures (about 70 s on the CPU);
# tests/test_torch_cli.py holds the port's CLI on the CPU to this set
FLAGSHIP_METRIC_KEYS = frozenset({
    "epoch", "time", "epoch_time_s", "train_loss",
    "val_mae_u", "val_mae_u_un", "val_pde_loss_u", "val_pde_loss_gt",
    "val_mae_h", "val_mae_h_un", "val_pde_loss_h",
    "test_mae_u", "test_mae_u_un", "test_pde_loss_u", "test_pde_loss_gt",
    "test_mae_h", "test_mae_h_un", "test_pde_loss_h",
})
# eval_model against the resumed run's own test: the same checkpoint and
# seeds; K1's statistics sum through fp32 atomics in another order each run
# The metric keys the JAX package's run.main writes for the diffusion
# baselines with one epoch (train, validation at epoch 0, the test with
# edm_sampler, whose n_time_h 128 leaves no known-region keys), written
# down from one JAX run of config_ddim_res32.yaml and
# config_adm_res32_cond_h.yaml on tests/test_torch_cli.py's fixtures;
# tests/test_torch_cli.py holds the port's CLI on the CPU to them
DDIM_METRIC_KEYS = frozenset({"epoch", "epoch_time_s", "time", "train_loss"} | {
    f"{s}_{k}" for s in ("val", "test")
    for k in ("mae_h", "mae_u", "mae_h_un", "mae_u_un", "mae_h_scaled",
              "mae_u_scaled", "corr_h", "corr_u", "pde_loss")} | {
    "test_mae_hu_un", "test_pde_loss_gt"})
COND_METRIC_KEYS = frozenset({"epoch", "epoch_time_s", "time", "train_loss"} | {
    f"{s}_{k}" for s in ("val", "test")
    for k in ("mae_u", "mae_u_un", "mae_u_scaled", "corr_u", "pde_loss")} | {
    "test_pde_loss_gt"})
TOL_CLI = 1e-4


def cli_stores(res: int):
    """The phase's seeded shallow-water fields as train and test trajectory
    stores, on the swe_per grid (x in [-0.5, 0.5], t in [0, 0.128])."""
    from m_cedm_tpu_torch.data.h5_io import TrajectoryStore, store_stats

    rs = np.random.RandomState(SEED + 20)
    x = np.linspace(-0.5, 0.5, res, dtype=np.float32)
    t = np.linspace(0.0, 0.128, res, dtype=np.float32)
    stores = {}
    for split, n in (("train", CLI_TRAIN), ("test", CLI_TEST)):
        h, _, _, u = synthetic_swe_batch(rs, n, res)
        attrs = {k: np.asarray(v, np.float32) for k, v in store_stats(h, u).items()}
        stores[split] = TrajectoryStore(inputs=h, targets=u, x=np.tile(x, (n, 1)),
                                        t=np.tile(t, (n, 1)), consts={}, attrs=attrs)
    return stores


class CliProbe:
    """For the phase, the task class's (McedmTask's unless another is given)
    train_step and eval_step record each call:
    host-clock seconds between torch.cuda.synchronize() calls, the kernel
    launches it made, and (eval) its U-Net forwards and samples."""

    def __init__(self, cls=None):
        from m_cedm_tpu_torch.tasks.diffusion import McedmTask

        self.cls = cls or McedmTask
        self.steps, self.evals = [], []

    def _wrap(self, fn, records, is_eval):
        import torch

        from m_cedm_tpu_torch import kernels

        def wrapped(task, *args, **kw):
            torch.cuda.synchronize()
            before, calls = kernels.launches(), getattr(task.model, "calls", 0)
            t0 = time.perf_counter()
            out = fn(task, *args, **kw)
            torch.cuda.synchronize()
            rec = {"s": time.perf_counter() - t0,
                   "launches": {k: v - before[k] for k, v in kernels.launches().items()}}
            if is_eval:
                rec.update(split=kw.get("split"),
                           forwards=getattr(task.model, "calls", 0) - calls,
                           samples=int(args[1][0].shape[0]) * kw.get("n_samples", 1))
            records.append(rec)
            return out

        return wrapped

    def __enter__(self):
        self.saved = self.cls.train_step, self.cls.eval_step
        self.cls.train_step = self._wrap(self.saved[0], self.steps, False)
        self.cls.eval_step = self._wrap(self.saved[1], self.evals, True)
        return self

    def __exit__(self, *exc):
        self.cls.train_step, self.cls.eval_step = self.saved


def read_metrics(run_dir: str) -> list:
    import os

    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    bad = [(r["epoch"], k) for r in recs for k, v in r.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{run_dir}: non-finite metrics {bad}")
    return recs


def folded_ensemble_check(device, hparams, params, n: int) -> dict:
    """The test ensemble folded into the batch against its members sampled
    one by one, on the card: McedmTask.eval_step at B = 16 with n members and
    the same explicit noise, its mean sample against the mean of n
    single-member evals (each kernel computes per sample, K1's statistics
    per sample and group, so only the summation order may differ)."""
    import torch

    from m_cedm_tpu_torch.tasks import build_task

    batch, mask, stats = flagship_eval_data(device, hparams, BATCH)
    task = build_task(hparams, device)
    state = task.init_state(None, stats, params=params)
    steps = hparams["sampler"]["timesteps"]
    shape = (BATCH,) + tuple(mask.shape)
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    cond = torch.randn(shape, generator=gen, device=device)
    init = torch.randn((n,) + shape, generator=gen, device=device)
    churn = torch.randn((n, steps) + shape, generator=gen, device=device)

    def run_eval(members):
        return task.eval_step(state, batch, None, mask, split="test", mask_name="u",
                              n_samples=len(members), cond_noise=cond,
                              init_noise=init[members.start:members.stop],
                              churn_noise=churn[members.start:members.stop])

    task.model.calls = 0
    metrics, folded = run_eval(range(n))
    calls = task.model.calls
    members = torch.stack([run_eval(range(i, i + 1))[1] for i in range(n)]).mean(0)
    rec = compare(folded, members, TOL_METRICS, "folded ensemble vs member by member")
    if calls != 2 * steps - 1:
        raise AssertionError(f"the folded ensemble took {calls} U-Net calls")
    return {"n_samples": n, "unet_forwards_folded": calls, **rec,
            "metrics": {k: float(v) for k, v in metrics.items()}}


def cli_kernel_vs_plain(device, config_name: str, overrides, run_dir: str,
                        masked: bool = True, need=("K1 gn_silu_bwd", "K2 gn_silu_conv"),
                        unheld=()) -> dict:
    """Every kernel of a config's path against its plain version at the
    shapes the CLI gives it. The CLI's own config and datamodule (composed
    from the same overrides), the fit's checkpoint restored into a
    kernel-path task and a plain-path one (PLAIN_OPS), set up as run.main and
    the Trainer set them up; then on both, from the same generator seeds: one
    train step on the datamodule's first train batch (B = 32), its loss and
    gradient norm within TOL_TRAIN and its params within 2 lr; and the test
    eval (of mask "u" where `masked`) on the first test batch with the
    configured n_samples folded into one sampler call (B = 80), its metrics
    but `unheld` within TOL_METRICS and its mean sample within TOL_METRICS of
    scale. The kernel path must launch every kernel in `need`, the plain path
    none."""
    import os

    import torch

    from m_cedm_tpu_torch import config, kernels, run
    from m_cedm_tpu_torch.train.checkpoint import CheckpointManager
    from m_cedm_tpu_torch.train.loop import batch_to_device

    cfg = config.compose(run.CONFIG_DIR, config_name, overrides)
    run.route_data(cfg)
    dm = config.instantiate(cfg.datamodule)
    seed = cfg.get("seed", 0)
    n_samples = cfg.diff_sampler.n_samples
    train_batch = batch_to_device(next(dm.iter_split("train", np.random.default_rng(seed))),
                                  device)
    test_batch = batch_to_device(next(dm.iter_split("test")), device)
    eval_kw = ({"mask": torch.from_numpy(dm.eval_masks("test")["u"]).to(device),
                "mask_name": "u"} if masked else {})
    out = {}
    for path, ops in (("kernel", kernels.DEVICE_OPS), ("plain", kernels.PLAIN_OPS)):
        task = config.instantiate(cfg.model, device=device, ops=ops,
                                  grad_clip=cfg.trainer.get("gradient_clip_val"))
        task.set_test_sampler_params(cfg.diff_sampler)
        task.set_pde_loss_function(cfg.system, dm.flip_xy)
        if hasattr(task, "set_train_mask_kind"):
            task.set_train_mask_kind(getattr(dm, "train_mask_kind", None))
        state = task.init_state(torch.Generator().manual_seed(seed), dm.get_norm_stats())
        state = CheckpointManager(os.path.join(run_dir, "checkpoints")).restore(state)
        before = kernels.launches()
        gen = torch.Generator(device=device).manual_seed(SEED + 30)
        new_state, step = task.train_step(state, train_batch, gen)
        gen = torch.Generator(device=device).manual_seed(SEED + 31)
        metrics, sample = task.eval_step(new_state, test_batch, gen, split="test",
                                         n_samples=n_samples, **eval_kw)
        out[path] = {"step": {k: float(v) for k, v in step.items()},
                     "metrics": {k: float(v) for k, v in metrics.items()},
                     "sample": sample, "params": new_state.params, "start": state.params,
                     "launches": {k: v - before[k] for k, v in kernels.launches().items()}}
    k, p = out["kernel"], out["plain"]
    if not all(k["launches"][name] for name in need):
        raise AssertionError(f"the kernel path launched {k['launches']}, needs {need}")
    if any(p["launches"].values()):
        raise AssertionError(f"the plain path launched {p['launches']}")
    for key in ("train_loss", "grad_norm"):
        a, b_ = k["step"][key], p["step"][key]
        if not math.isfinite(a) or abs(a - b_) > TOL_TRAIN * abs(b_):
            raise AssertionError(f"CLI train step {key}: kernel {a} vs plain {b_}")
    lr = cfg.model.hparams.optimization.lr
    params_diff = max(float((k["params"][n] - p["params"][n]).abs().max()) for n in p["params"])
    moved = max(float((p["params"][n] - p["start"][n]).abs().max()) for n in p["params"])
    if not (params_diff <= 2 * lr and moved > 0):
        raise AssertionError(f"CLI train step params: {params_diff} apart, moved {moved}")
    for key, b_ in p["metrics"].items():
        a = k["metrics"][key]
        if not math.isfinite(a) or (abs(a - b_) > TOL_METRICS * max(1.0, abs(b_))
                                    and key not in unheld):
            raise AssertionError(f"CLI test {key}: kernel {a} vs plain {b_}")
    sample = compare(k["sample"], p["sample"], TOL_METRICS, "CLI test sample")
    return {"train_batch": int(train_batch[0].shape[0]),
            "test_batch_folded": int(test_batch[0].shape[0]) * n_samples,
            "train_step": {"kernel": k["step"], "plain": p["step"], "tol": TOL_TRAIN,
                           "params_max_abs_diff": params_diff, "tol_params": 2 * lr},
            "test": {"kernel": k["metrics"], "plain": p["metrics"], "tol": TOL_METRICS,
                     "unheld": list(unheld), "sample": sample},
            "launches": {path: {n: v for n, v in out[path]["launches"].items() if v}
                         for path in out}}


def phase_cli(device, params) -> dict:
    """The flagship through the port's CLI at full width and depth:
    m_cedm_tpu_torch.run on configs/config_adm_edm_mcedm_res32.yaml (one
    epoch of 2 steps at batch 32, validation at epoch 0, the test with 50
    Heun steps, S_churn 15 and n_samples 5), then a resume to epoch 2, then
    m_cedm_tpu_torch.eval_model on the resumed run; then
    folded_ensemble_check on phase 3's weights. Returns the launches of the
    three CLI runs (the check after them is not counted), the resumed run's
    directory and eval_model's, which phase 15 reads and then removes."""
    import importlib.util
    import os
    import shutil

    from m_cedm_tpu_torch import eval_model, kernels, run
    from m_cedm_tpu_torch.data import datamodule as dm_module
    from m_cedm_tpu_torch.data.h5_io import write_store

    # the machine's optional packages decide the data and callbacks, once
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("h5py", "matplotlib", "wandb")}
    res = FLAGSHIP_HPARAMS["model"]["resolution"]
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "cli_phase")
    shutil.rmtree(root, ignore_errors=True)
    sub = os.path.join(root, "1D_swp_128_per")
    os.makedirs(sub)
    stores = cli_stores(res)
    paths = {split: os.path.join(sub, f"1D_swp_128_per_{split}.h5") for split in stores}
    saved_read, saved_wandb = dm_module.read_store, sys.modules.get("wandb")
    if have["h5py"]:
        for split, s in stores.items():
            write_store(paths[split], s.inputs, s.targets, s.x, s.t)
    else:  # the same stores, served to the datamodule by path
        by_path = {paths[split]: s for split, s in stores.items()}
        dm_module.read_store = by_path.__getitem__
    # no wandb run (offline, it would start a service process of its own)
    sys.modules["wandb"] = None
    job = ["system=swe_per", f"dataroot={root}"]
    if not have["matplotlib"]:
        job.append("callbacks=callbacks_save_model")
    base = ["--config-name", CLI_CONFIG] + job
    run_dir, run2_dir, eval_dir = (os.path.join(root, d) for d in ("run", "run2", "eval"))
    secs = {}
    kernels.reset_launches()
    try:
        with CliProbe() as probe:
            for name, fn, extra in (
                    ("fit", run.main, ["trainer.max_epochs=1", f"hydra.run.dir={run_dir}"]),
                    ("resume", run.main, [f"ckpt_path={run_dir}", "trainer.max_epochs=2",
                                          "override_epochs=true",
                                          f"hydra.run.dir={run2_dir}"]),
                    ("eval_model", eval_model.main, [f"ckpt_path={run2_dir}",
                                                     f"hydra.run.dir={eval_dir}"])):
                t0 = time.perf_counter()
                fn(base + extra)
                secs[name] = time.perf_counter() - t0
        launches = kernels.launches()
        vs_plain = cli_kernel_vs_plain(device, CLI_CONFIG, job + ["trainer.max_epochs=1"],
                                       run_dir)
    finally:
        dm_module.read_store = saved_read
        if saved_wandb is None:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = saved_wandb

    recs = {d: read_metrics(p) for d, p in (("run", run_dir), ("run2", run2_dir),
                                              ("eval", eval_dir))}
    for d in ("run", "run2"):
        keys = set().union(*map(set, recs[d]))
        if keys != FLAGSHIP_METRIC_KEYS:
            raise AssertionError(f"{d} metric keys {sorted(keys ^ FLAGSHIP_METRIC_KEYS)} "
                                 f"differ from the JAX package's")
    trained = sorted(r["epoch"] for r in recs["run2"] if "train_loss" in r)
    if trained != [1]:
        raise AssertionError(f"the resumed run trained epochs {trained}, expected [1]")
    run2_test = [r for r in recs["run2"] if "test_mae_u" in r][-1]
    (eval_test,) = recs["eval"]
    test_keys = {k for k in run2_test if k.startswith("test_")}
    if test_keys != {k for k in eval_test if k.startswith("test_")}:
        raise AssertionError(f"eval_model keys {sorted(eval_test)}")
    eval_err = {k: abs(eval_test[k] - run2_test[k]) / max(abs(run2_test[k]), 1e-30)
                for k in test_keys}
    if max(eval_err.values()) > TOL_CLI:
        raise AssertionError(f"eval_model vs the resumed run's test: {eval_err}")

    # every train step and every U-Net forward of the CLI launched what
    # phases 4 and 5 launch
    want_step = {"K2 gn_silu_conv": K2_PER_FORWARD, "K2 narrow_conv": NARROW_PER_FORWARD,
                 "K2 gn_silu_conv_bwd": K2_BWD_PER_STEP,
                 "K2 narrow_conv_bwd": NARROW_BWD_PER_STEP,
                 "K1 gn_silu_bwd": K1_BWD_PER_STEP, "K4 attention": 4,
                 "K4 attention_bwd": 4}
    for i, rec in enumerate(probe.steps):
        got = {k: rec["launches"][k] for k in want_step}
        if got != want_step:
            raise AssertionError(f"CLI train step {i}: launches {got}, expected {want_step}")
    want_fwd = {"K2 gn_silu_conv": K2_PER_FORWARD, "K2 narrow_conv": NARROW_PER_FORWARD,
                "K4 attention": 4}
    for i, rec in enumerate(probe.evals):
        got = {k: rec["launches"][k] for k in want_fwd}
        want = {k: v * rec["forwards"] for k, v in want_fwd.items()}
        if got != want or rec["launches"]["K2 gn_silu_conv_bwd"]:
            raise AssertionError(f"CLI eval {i} ({rec['forwards']} forwards): "
                                 f"launches {got}, expected {want}")
    missing = [k for k in FLAGSHIP_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the CLI: {missing}")
    if len(probe.steps) != 4:
        raise AssertionError(f"{len(probe.steps)} train steps, expected 2 + 2")

    tests = [r for r in probe.evals if r["split"] == "test"]
    ckpt_dir = os.path.join(run2_dir, "checkpoints")
    ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, files in os.walk(ckpt_dir) for f in files)
    ckpts = sorted(os.listdir(ckpt_dir))
    step_ms = [r["s"] * 1e3 for r in probe.steps]
    folded = folded_ensemble_check(device, FLAGSHIP_HPARAMS, params, 5)
    emit({"phase": "cli", "config": CLI_CONFIG, "nvidia_smi": nvidia_smi_line(),
          "data": "h5" if have["h5py"] else "in_memory",
          "callbacks": "configured" if have["matplotlib"] else "callbacks_save_model",
          "wandb": "not imported", "packages": have,
          "trajectories": {"train": CLI_TRAIN, "test": CLI_TEST}, "res": res,
          "seconds": secs, "train_step_ms": step_ms,
          "train_step_ms_median": float(np.median(step_ms)),
          "test_samples_per_s": [r["samples"] / r["s"] for r in tests],
          "test_unet_forwards": [r["forwards"] for r in tests],
          "test_batch": [r["samples"] for r in tests],
          "checkpoint_mb": ckpt_bytes / 1e6, "checkpoints_kept": ckpts,
          "eval_model_max_rel_err": max(eval_err.values()), "tol": TOL_CLI,
          "test_metrics": {k: run2_test[k] for k in sorted(test_keys)},
          "folded_ensemble": folded, "kernel_vs_plain": vs_plain,
          "launches": {k: v for k, v in launches.items() if v}})
    return launches, run2_dir, eval_dir


# ---------------------------------------------------------------------------
# phase 13: the diffusion baselines (the DDPM U-Net, DdimTask, CondDdimTask,
# CondEdmTask training)
# ---------------------------------------------------------------------------

def _variant(base: dict, name: str, drop=(), **model) -> dict:
    """A copy of a config's hparams with another name and model keys."""
    hp = json.loads(json.dumps(base))
    hp["name"] = name
    hp["model"].update(model)
    for k in drop:
        del hp["model"][k]
    return hp


# the `hparams` blocks of configs/model/{adm_cond_h_res32, ddim_cond_h_res32,
# edm_cond_h_res32, ddim_res32}.yaml: adm_edm_cond_h's but for these keys (a
# test holds each equal to its file)
ADM_COND_HPARAMS = _variant(COND_EDM_HPARAMS, "adm_cond_h")
DDIM_COND_HPARAMS = _variant(COND_EDM_HPARAMS, "ddim_cond_h", self_cond=True)
EDM_COND_HPARAMS = _variant(COND_EDM_HPARAMS, "edm_cond_h")
DDIM_HPARAMS = _variant(COND_EDM_HPARAMS, "ddim",
                        drop=("cond_p", "add_cond_mask", "add_xt", "node_type"),
                        in_channels=2, cond_channels=0, cat_cond=False, out_ch=2,
                        self_cond=True)
DDIM_TARGET = "m_cedm_tpu.tasks.DdimTask"
COND_DDIM_TARGET = "m_cedm_tpu.tasks.CondDdimTask"
# configs/diff_sampler/ddim_sampler.yaml: RePaint DDIM, 5 rounds a step
DDIM_SAMPLER = {"name": "ddim", "type": "ddim", "timesteps": 50,
                "skip_type": "uniform", "eta": 0.0, "n_samples": 5, "n_repeat": 5,
                "n_time_h": 128, "n_time_u": 0, "return_last": True,
                "select_by_pde": False, "use_gt_pde_select": True, "guide_dx": False,
                "w": 0.0, "plot_scaled": False}
# Per DDPM U-Net forward at full width and depth (res 128, 64, 32; attention
# at 32): 22 K2 calls in the 11 ResnetBlocks and 2 in the Upsamples' convs;
# conv_in and conv_out on the narrow kernel; K4 at the four attention
# sites; K1's apply in the out head and its statistics pass where a block's
# input comes without statistics (after the two Downsamples and the two
# middle attention sites, and for five decoder concats: over the half
# without statistics, or over both halves where neither has them).
# tests/test_torch_ddpm_unet.py holds these to the calls of one forward.
DDPM_PER_FORWARD = {"K2 gn_silu_conv": 24, "K2 narrow_conv": 2, "K4 attention": 4,
                    "K1 gn_silu": 1, "K1 channel_stats": 9}
# Per train step's backward: K2's backward for the 24 K2 calls and conv_in
# (its wgrad), the narrow backward for conv_out, K1's for the out head, K4's
# at the four attention sites
DDPM_BWD_PER_STEP = {"K2 gn_silu_conv_bwd": 25, "K2 narrow_conv_bwd": 1,
                     "K1 gn_silu_bwd": 1, "K4 attention_bwd": 4}
DDPM_KERNELS = tuple(DDPM_PER_FORWARD) + tuple(DDPM_BWD_PER_STEP)
# the ADM U-Net's per train step (phase 5's)
ADM_STEP = {"K2 gn_silu_conv": K2_PER_FORWARD, "K2 narrow_conv": NARROW_PER_FORWARD,
            "K2 gn_silu_conv_bwd": K2_BWD_PER_STEP,
            "K2 narrow_conv_bwd": NARROW_BWD_PER_STEP,
            "K1 gn_silu_bwd": K1_BWD_PER_STEP, "K4 attention": 4, "K4 attention_bwd": 4}
ADM_FORWARD = {"K2 gn_silu_conv": K2_PER_FORWARD, "K2 narrow_conv": NARROW_PER_FORWARD,
               "K4 attention": 4}
# the self-conditioning branch of the three train steps, injected: taken,
# not taken, taken
SC_BRANCHES = (True, False, True)
# test_pde_loss, the PDE residual of the samples, is reported on both paths
# and not held: at an untrained net's sample amplitudes (hundreds to
# thousands of the data's scale; the DDPM-as-EDM denoiser is x - sigma F)
# the finite-volume step divides by depths near zero and amplifies the
# samples' rounding differences by orders of magnitude. pde_conditioning
# shows this on the card beside every gap, and holds the clamped residual
# (clamp_loss=True, each element at most 1), which bounds what one element
# can add; tests/test_torch_ddim_eval.py holds the residual to the JAX
# package's on identical fields.
UNHELD_METRICS = ("test_pde_loss",)
DDPM_RUNS = 3  # timed calls per case of the kernel phase
PDE_DRAWS = 4  # sign draws of pde_conditioning


def phase_ddpm_kernels(device, b: int) -> dict:
    """K2 and K1 at the DDPM U-Net's shapes (32 groups, eps 1e-6: 2 channels
    a group at 64, 4 at the decoder's 128-channel concat), each against its
    plain version: K2's identity block tail (64 -> 64) and its projection over
    the concat (128 -> 64) at res 128, 64 and 32, fed chained statistics,
    and K1's apply at C 64 and 128 (res 128); forward within TOL_KERNEL,
    backward (every input's gradient, against the plain path's autograd)
    within TOL_BWD; kernel and plain times of the forward and the backward."""
    import torch

    from m_cedm_tpu_torch.kernels import fused_norm as fn
    from m_cedm_tpu_torch.kernels import fused_norm_conv as fnc
    from m_cedm_tpu_torch.models.layers import DDPM_EPS, DDPM_GROUPS

    g = torch.Generator(device=device).manual_seed(SEED + 40)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device=device) * scale + shift
                ).requires_grad_()

    def timed(fwd, leaves, cot):
        """(forward ms, backward ms) of one path."""
        out = fwd()
        ms = cuda_ms(lambda: fwd(), DDPM_RUNS, CALLS_PER_RUN)
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, cot, retain_graph=True),
                         DDPM_RUNS, CALLS_PER_RUN)
        return ms, bwd_ms

    recs = []

    def check(name, k_fwd, p_fwd, leaves, work):
        k_out, p_out = k_fwd(), p_fwd()
        k_main = k_out[0] if isinstance(k_out, tuple) else k_out
        p_main = p_out[0] if isinstance(p_out, tuple) else p_out
        errs = [compare(k_main, p_main, TOL_KERNEL, f"{name} output")]
        if isinstance(k_out, tuple):
            errs += [compare(a, w, TOL_KERNEL, f"{name} emitted stats {i}")
                     for i, (a, w) in enumerate(zip(k_out[1], p_out[1]))]
        cot = torch.randn(p_main.shape, generator=g, device=device)
        k_g = torch.autograd.grad(k_main, leaves, cot, retain_graph=True)
        p_g = torch.autograd.grad(p_main, leaves, cot, retain_graph=True)
        g_errs = [compare(a, w, TOL_BWD, f"{name} gradient {i}")
                  for i, (a, w) in enumerate(zip(k_g, p_g))]
        ms, bwd_ms = timed(lambda: (k_fwd()[0] if isinstance(k_out, tuple) else k_fwd()),
                           leaves, cot)
        pms, pbwd_ms = timed(lambda: (p_fwd()[0] if isinstance(p_out, tuple) else p_fwd()),
                             leaves, cot)
        rec = {"phase": "ddpm_kernel", "case": name,
               "max_rel_err": max(e["max_rel_err"] for e in errs),
               "max_abs_err": max(e["max_abs_err"] for e in errs), "tol": TOL_KERNEL,
               "bwd_max_rel_err": max(e["max_rel_err"] for e in g_errs),
               "bwd_tol": TOL_BWD, "ms": ms, "plain_ms": pms, "backward_ms": bwd_ms,
               "plain_backward_ms": pbwd_ms, **bound(*work)}
        emit(rec)
        recs.append(rec)

    for c_in in (64, 128):
        o = 64
        for r in (128, 64, 32):
            x = rnd(b, r, r, c_in, scale=0.8, shift=0.2)
            gamma, beta = rnd(b, c_in, scale=0.3, shift=1.0), rnd(b, c_in, scale=0.3)
            w = rnd(3, 3, c_in, o, scale=1.0 / math.sqrt(9 * c_in))
            bias = rnd(o, scale=0.3)
            with torch.no_grad():
                stats = fn.channel_stats_plain(x.reshape(b, -1, c_in))
            kw, leaves = {"residual": x}, [x, gamma, beta, w, bias]
            if c_in != o:
                skw, skb = rnd(c_in, o, scale=1.0 / math.sqrt(c_in)), rnd(o, scale=0.3)
                kw.update(skip_w=skw, skip_b=skb)
                leaves += [skw, skb]

            def k_fwd(x=x, gamma=gamma, beta=beta, w=w, bias=bias, kw=kw, stats=stats):
                return fnc.gn_silu_conv(x, gamma, beta, w, bias, DDPM_GROUPS, DDPM_EPS,
                                        stats=stats, emit_stats=True, **kw)

            def p_fwd(x=x, gamma=gamma, beta=beta, w=w, bias=bias, kw=kw):
                return fnc.gn_silu_conv_plain(x, gamma, beta, w, bias, DDPM_GROUPS,
                                              DDPM_EPS, emit_stats=True, **kw)

            mode = "identity" if c_in == o else "projection"
            work = (nbytes(x, gamma, beta, w, bias, *stats, kw.get("skip_w"),
                           kw.get("skip_b")) + 4 * (b * r * r * o + 2 * b * o),
                    conv_flops(b, r, r, c_in, o)
                    + (2.0 * b * r * r * c_in * o if c_in != o else 0.0), 3)
            check(f"K2 {mode} {c_in}->{o} res {r}", k_fwd, p_fwd, leaves, work)
        # K1's apply at 32 groups (the out head is C 64 at res 128)
        r = 128
        x = rnd(b, r * r, c_in, scale=0.8, shift=0.2)
        gamma, beta = rnd(b, c_in, scale=0.3, shift=1.0), rnd(b, c_in, scale=0.3)
        with torch.no_grad():
            stats = fn.channel_stats_plain(x)
        check(f"K1 gn_silu C {c_in} res {r}",
              lambda x=x, gamma=gamma, beta=beta, stats=stats: fn.gn_silu(
                  x, gamma, beta, DDPM_GROUPS, DDPM_EPS, stats=stats),
              lambda x=x, gamma=gamma, beta=beta: fn.gn_silu_plain(
                  x, gamma, beta, DDPM_GROUPS, DDPM_EPS),
              [x, gamma, beta],
              (nbytes(x, gamma, beta, *stats) + 4 * x.numel(), 6.0 * x.numel()))
    return {rec["case"]: {k: rec[k] for k in ("ms", "plain_ms", "backward_ms",
                                               "plain_backward_ms", "bound_ms",
                                               "bound_by", "max_rel_err",
                                               "bwd_max_rel_err")}
            for rec in recs}


def baseline_data(device, hparams, b: int, seed: int):
    import torch

    r = hparams["model"]["resolution"]
    h, tg, xg, u = synthetic_swe_batch(np.random.RandomState(seed), b, r)
    stats = {"input_mean": h.mean(), "input_std": h.std(),
             "target_mean": u.mean(), "target_std": u.std()}
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (h, tg, xg, u)), stats


def expect_launches(got: dict, want: dict, n: int, what: str) -> None:
    want = {k: v * n for k, v in want.items()}
    got = {k: got[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: launched {got}, expected {want}")


def pde_residual(task, state, batch, pred, clamp: bool) -> float:
    """test_pde_loss of a one-member eval's sample, as eval_step computes it
    (the member's mean is the member)."""
    import torch

    from m_cedm_tpu_torch.tasks import CondDdimTask

    if isinstance(task, CondDdimTask):
        h = task.transform.forward(state, batch[0], batch[3])[..., :task.h_ch]
        m = task._pde_matrix_cond(state, h, pred, clamp_loss=clamp)
    else:
        m = task._pde_matrix_joint(state, pred, clamp_loss=clamp)
    return float(torch.sum(m)) / batch[0].shape[0]


def pde_conditioning(task, state, batch, pred, plain_pred, plain_pde: float,
                     seed: int, what: str) -> dict:
    """How far the PDE residual of a sample moves under a perturbation the
    size of the kernel path's difference from the plain path, d = pred -
    plain_pred: the gap (the residual of pred against plain_pred's, relative)
    beside the spread of PDE_DRAWS residuals of plain_pred + s * d, s a
    seeded random sign per element (the same magnitudes at the same places).
    The clamped residual (each element at most 1) of pred is held within
    TOL_METRICS of plain_pred's; its mean per element (1 where every
    element is clamped) is reported."""
    import torch

    base = pde_residual(task, state, batch, plain_pred, False)
    if abs(base - plain_pde) > 1e-5 * abs(plain_pde):
        raise AssertionError(f"{what}: residual {base} recomputed, eval gave {plain_pde}")
    d = pred - plain_pred
    g = torch.Generator(device=pred.device).manual_seed(seed)
    spread = []
    for _ in range(PDE_DRAWS):
        sign = torch.randint(0, 2, d.shape, generator=g, device=d.device) * 2 - 1
        r = pde_residual(task, state, batch, plain_pred + sign * d, False)
        spread.append(abs(r - base) / abs(base))
    clamped = {name: pde_residual(task, state, batch, x, True)
               for name, x in (("kernel", pred), ("plain", plain_pred))}
    clamped_rel = (abs(clamped["kernel"] - clamped["plain"])
                   / max(1.0, abs(clamped["plain"])))
    if not clamped_rel <= TOL_METRICS:
        raise AssertionError(f"{what} clamped PDE residual (kernel, plain): {clamped}")
    n_el = pred.numel() if pred.shape[-1] == 2 else 2 * pred.numel()  # (h, u)
    return {"gap": abs(pde_residual(task, state, batch, pred, False) - base) / abs(base),
            "spread": spread, "sample_max_abs_diff": float(d.abs().max()),
            "sample_max_abs": float(plain_pred.abs().max()),
            "clamped": clamped, "clamped_rel_diff": clamped_rel, "tol": TOL_METRICS,
            "clamped_mean_per_element": clamped["plain"] * batch[0].shape[0] / n_el}


def baseline_eval(device, target, hparams, params, sparams, b: int, seed: int,
                  paths=(("kernel", False), ("plain", False))) -> dict:
    """One eval_step (n_samples 1) of a baseline on each path, the same
    weights and generator seed; metrics and the sample of every path within
    TOL_METRICS of the plain path's, the launches and the U-Net forwards of
    each kernel path, wall seconds. UNHELD_METRICS are reported, not held;
    pde_conditioning beside them."""
    import torch

    from m_cedm_tpu_torch import kernels
    from m_cedm_tpu_torch.tasks import build_task

    batch, stats = baseline_data(device, hparams, b, seed)
    out = {}
    for name, mega in paths:
        ops = kernels.PLAIN_OPS if name == "plain" else kernels.DEVICE_OPS
        task = build_task(hparams, device, target=target, ops=ops, mega=mega)
        task.set_test_sampler_params(sparams)
        state = task.init_state(None, stats, params=params)
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        task.model.calls = 0
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics, pred = task.eval_step(state, batch, gen, split="test")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gt = task.transform.forward(state, batch[0], batch[3])
        out[name] = {"metrics": {k: float(v) for k, v in metrics.items()}, "pred": pred,
                     "gt": gt, "launches": kernels.launches(), "wall_s": wall,
                     "forwards": task.model.calls, "task": task, "state": state,
                     "batch": batch}
    plain = out["plain"]
    if any(plain["launches"].values()):
        raise AssertionError(f"the plain path launched {plain['launches']}")
    rec = {"plain_metrics": plain["metrics"], "plain_wall_s": plain["wall_s"],
           "samples_per_s_plain": b / plain["wall_s"], "unet_forwards": plain["forwards"]}
    for name, _ in paths[:-1]:
        k = out[name]
        if not all(math.isfinite(v) for v in k["metrics"].values()):
            raise AssertionError(f"{name} metrics {k['metrics']}")
        rel = {key: abs(v - plain["metrics"][key]) / max(1.0, abs(plain["metrics"][key]))
               for key, v in k["metrics"].items()}
        bad = {key: (k["metrics"][key], plain["metrics"][key]) for key, e in rel.items()
               if e > TOL_METRICS and key not in UNHELD_METRICS}
        if bad:
            raise AssertionError(f"{hparams['name']} {name} metrics (kernel, plain): {bad}")
        rec[name] = {"metrics": k["metrics"], "metrics_max_rel_diff": rel,
                     "wall_s": k["wall_s"], "samples_per_s": b / k["wall_s"],
                     "sample": compare(k["pred"], plain["pred"], TOL_METRICS,
                                       f"{hparams['name']} {name} sample"),
                     "pde_conditioning": pde_conditioning(
                         plain["task"], plain["state"], plain["batch"], k["pred"],
                         plain["pred"], plain["metrics"]["test_pde_loss"], seed + 2,
                         f"{hparams['name']} {name}"),
                     "launches": {kk: v for kk, v in k["launches"].items() if v}}
        out[name]["rec"] = rec[name]
    return rec, out


def baseline_train(device, target, hparams, params, b: int, seed: int,
                   self_cond: bool) -> dict:
    """Three train steps of a baseline from one state on the kernel path and
    the plain path, the same generator seeds (and the self-conditioning
    branch injected where the model has it: SC_BRANCHES); loss and gradient
    norm of each step within TOL_TRAIN, params and EMA within 2 lr steps;
    the launches of each kernel-path step and ms per step on both paths."""
    import torch

    from m_cedm_tpu_torch import kernels
    from m_cedm_tpu_torch.tasks import build_task

    batch, stats = baseline_data(device, hparams, b, seed)
    lr = hparams["optimization"]["lr"]
    out = {}
    for name, ops in (("kernel", kernels.DEVICE_OPS), ("plain", kernels.PLAIN_OPS)):
        task = build_task(hparams, device, target=target, ops=ops)
        state = task.init_state(None, stats, params=params)
        start = state
        metrics, walls, launches = [], [], []
        for i in range(TRAIN_STEPS):
            gen = torch.Generator(device=device).manual_seed(seed + 10 + i)
            draws = {"use_sc": SC_BRANCHES[i]} if self_cond else {}
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = task.train_step(state, batch, gen, **draws)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches.append(kernels.launches())
            metrics.append({k: float(v) for k, v in m.items()})
        out[name] = {"metrics": metrics, "state": state, "start": start,
                     "walls": walls, "launches": launches, "task": task}
    k, p = out["kernel"], out["plain"]
    for step, (km, pm) in enumerate(zip(k["metrics"], p["metrics"])):
        for key in ("train_loss", "grad_norm"):
            if not math.isfinite(km[key]) or abs(km[key] - pm[key]) > TOL_TRAIN * abs(pm[key]):
                raise AssertionError(f"{hparams['name']} step {step} {key}: kernel "
                                     f"{km[key]} vs plain {pm[key]}")
    if any(v for lp in p["launches"] for v in lp.values()):
        raise AssertionError("the plain path launched kernels")

    def max_diff(a, b_):
        return max(float((a[n] - b_[n]).abs().max()) for n in a)

    diffs = {"params": max_diff(k["state"].params, p["state"].params),
             "ema_params": max_diff(k["state"].ema_params, p["state"].ema_params)}
    tol_params = 2 * lr * TRAIN_STEPS
    if not (diffs["params"] <= tol_params and diffs["ema_params"] <= tol_params
            and max_diff(k["state"].params, k["start"].params) > 0):
        raise AssertionError(f"{hparams['name']} params after {TRAIN_STEPS} steps: {diffs}")
    rec = {"train_loss": [m["train_loss"] for m in k["metrics"]],
           "plain_train_loss": [m["train_loss"] for m in p["metrics"]],
           "grad_norm": [m["grad_norm"] for m in k["metrics"]],
           "plain_grad_norm": [m["grad_norm"] for m in p["metrics"]],
           "tol": TOL_TRAIN, "max_abs_diff": diffs, "tol_params": tol_params,
           # the first step compiles nothing but warms the allocator: the
           # later steps' median
           "ms_per_step": float(np.median(k["walls"][1:])) * 1e3,
           "plain_ms_per_step": float(np.median(p["walls"][1:])) * 1e3,
           "self_cond_branches": list(SC_BRANCHES) if self_cond else None}
    return rec, out


def temb_proj_grads(device, hparams, params, b: int, seed: int) -> dict:
    """The gradient of every ResnetBlock's temb_proj (its only path is h + t,
    whose statistics the second K2 takes chained) on the kernel path against
    the plain path, from one state and the same draws, each within TOL_BWD of
    its scale."""
    import torch

    from m_cedm_tpu_torch import kernels
    from m_cedm_tpu_torch.tasks import build_task

    batch, stats = baseline_data(device, hparams, b, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    n = batch[0].shape[0]
    draws = {"t_half": torch.randint(0, 1000, (n // 2 + 1,), generator=gen, device=device),
             "noise": torch.randn((n,) + tuple(batch[0].shape[1:3]) + (2,),
                                  generator=gen, device=device), "use_sc": False}
    grads = {}
    for name, ops in (("kernel", kernels.DEVICE_OPS), ("plain", kernels.PLAIN_OPS)):
        task = build_task(hparams, device, target=DDIM_TARGET, ops=ops)
        state = task.init_state(None, stats, params=params)
        _, g = task.loss_and_grads(state, batch, None, **draws)
        grads[name] = {k: v for k, v in g.items() if ".temb_proj." in k}
    errs = {k: compare(grads["kernel"][k], v, TOL_BWD, f"gradient of {k}")["max_rel_err"]
            for k, v in grads["plain"].items()}
    return {"tensors": len(errs), "max_rel_err": max(errs.values()), "tol": TOL_BWD}


def phase_ddim(device, b: int) -> dict:
    """DdimTask (configs/model/ddim_res32.yaml) at full width and depth on
    the DDPM U-Net: one eval with the model's sampler (RePaint DDPM-as-EDM
    Heun: 50 steps, S_churn 15, n_repeat 2, n_time_h 128) and one with
    ddim_sampler.yaml (RePaint DDIM, n_repeat 5), each on the kernel path and
    the plain path (metrics and sample within TOL_METRICS, the known channel
    within TOL_KNOWN of the ground truth on both); three train steps on both
    paths; temb_proj's gradient; the launches per forward and per step
    asserted. Returns the launches of the Heun eval and of the first train
    step (which takes the self-conditioning branch)."""
    from m_cedm_tpu_torch.tasks import build_task

    hp = DDIM_HPARAMS
    params = seeded_params(build_task(hp, "cpu", target=DDIM_TARGET).model, SEED + 50)
    evals = {}
    eval_launches = None
    for sname, sp in (("edm_repaint", hp["sampler"]), ("ddim_repaint", DDIM_SAMPLER)):
        rec, out = baseline_eval(device, DDIM_TARGET, hp, params, sp, b, SEED + 51)
        k = out["kernel"]
        expect_launches(k["launches"], DDPM_PER_FORWARD, k["forwards"],
                        f"DdimTask {sname} eval ({k['forwards']} forwards)")
        for path in ("kernel", "plain"):
            rec[f"known_h_{path}"] = compare(out[path]["pred"][..., :1],
                                             out[path]["gt"][..., :1], TOL_KNOWN,
                                             f"DdimTask {sname} {path} known channel")
        evals[sname] = rec
        if sname == "edm_repaint":
            eval_launches = k["launches"]
    train, out = baseline_train(device, DDIM_TARGET, hp, params, b, SEED + 52, True)
    for i, (sc, got) in enumerate(zip(SC_BRANCHES, out["kernel"]["launches"])):
        expect_launches(got, DDPM_PER_FORWARD, 1 + sc, f"DdimTask train step {i} forward")
        expect_launches(got, DDPM_BWD_PER_STEP, 1, f"DdimTask train step {i} backward")
    temb = temb_proj_grads(device, hp, params, b, SEED + 53)
    emit({"phase": "ddim", "config": "ddim_res32", "batch": b, "eval": evals,
          "train": train, "temb_proj_grad": temb,
          "launches_per_forward": DDPM_PER_FORWARD,
          "launches_per_step_backward": DDPM_BWD_PER_STEP})
    return {"eval": eval_launches, "step": out["kernel"]["launches"][0]}


def phase_cond_baselines(device, b: int) -> dict:
    """The conditional baselines at full width and depth, kernel path against
    the plain path: CondDdimTask on the DDPM U-Net (ddim_cond_h) and on the
    ADM U-Net (adm_cond_h, also with mega=True), and CondEdmTask on the DDPM
    U-Net (edm_cond_h), one eval each with the config's sampler (50 steps,
    DDPM-as-EDM Heun or EDM Heun) and three train steps each; CondEdmTask on
    the ADM U-Net (adm_edm_cond_h, whose serving phase 11 measures): three
    train steps. Launches per forward and per step asserted."""
    from m_cedm_tpu_torch.tasks import COND_EDM_TARGET as EDM_T
    from m_cedm_tpu_torch.tasks import build_task

    recs = {}
    cases = (("ddim_cond_h", DDIM_COND_HPARAMS, COND_DDIM_TARGET, True),
             ("edm_cond_h", EDM_COND_HPARAMS, EDM_T, True),
             ("adm_cond_h", ADM_COND_HPARAMS, COND_DDIM_TARGET, True),
             ("adm_edm_cond_h", COND_EDM_HPARAMS, EDM_T, False))
    for i, (name, hp, target, serve) in enumerate(cases):
        adm = name.startswith("adm")
        params = seeded_params(build_task(hp, "cpu", target=target).model, SEED + 60 + i)
        rec = {}
        if serve:
            paths = ((("kernel", False), ("mega", True), ("plain", False)) if adm
                     else (("kernel", False), ("plain", False)))
            rec["eval"], out = baseline_eval(device, target, hp, params, hp["sampler"],
                                             b, SEED + 70 + i, paths)
            k = out["kernel"]
            expect_launches(k["launches"], ADM_FORWARD if adm else DDPM_PER_FORWARD,
                            k["forwards"], f"{name} eval ({k['forwards']} forwards)")
            if adm:
                check_mega_launches(out["mega"]["launches"], out["mega"]["forwards"],
                                    f"{name} mega eval")
        sc = hp["model"]["self_cond"]
        rec["train"], out = baseline_train(device, target, hp, params, b, SEED + 80 + i, sc)
        for j, got in enumerate(out["kernel"]["launches"]):
            fwd = 1 + (sc and SC_BRANCHES[j])
            if adm:
                expect_launches(got, ADM_STEP, 1, f"{name} train step {j}")
            else:
                expect_launches(got, DDPM_PER_FORWARD, fwd, f"{name} train step {j} forward")
                expect_launches(got, DDPM_BWD_PER_STEP, 1, f"{name} train step {j} backward")
        recs[name] = rec
    emit({"phase": "cond_baselines", "batch": b, **recs})
    return recs


DDIM_CLI_CONFIG = "config_ddim_res32.yaml"


def phase_ddim_cli(device) -> dict:
    """config_ddim_res32.yaml through m_cedm_tpu_torch.run at full width and
    depth on phase 12's seeded fields (served as in-memory stores where h5py
    is missing): one epoch of 2 steps at batch 32, validation (the model's
    RePaint Heun sampler, batch 16), the test (edm_sampler: 50 Heun steps,
    n_repeat 2, n_samples 5 folded into batch 80). Every logged metric
    finite, the keys the JAX package's (DDIM_METRIC_KEYS), the launches of
    each train step and eval as phase 13's; seconds, ms per step and the
    test's samples/s. Then, the CLI's launches read, cli_kernel_vs_plain on
    the fit's checkpoint: one train step at B = 32 and the folded test eval
    at B = 80 on both paths (test_pde_loss reported, UNHELD_METRICS)."""
    import importlib.util
    import os
    import shutil

    from m_cedm_tpu_torch import kernels, run
    from m_cedm_tpu_torch.data import datamodule as dm_module
    from m_cedm_tpu_torch.data.h5_io import write_store
    from m_cedm_tpu_torch.tasks.diffusion import DdimTask

    have = {m: importlib.util.find_spec(m) is not None
            for m in ("h5py", "matplotlib", "wandb")}
    res = DDIM_HPARAMS["model"]["resolution"]
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "ddim_cli")
    shutil.rmtree(root, ignore_errors=True)
    sub = os.path.join(root, "1D_swp_128_per")
    os.makedirs(sub)
    stores = cli_stores(res)
    paths = {split: os.path.join(sub, f"1D_swp_128_per_{split}.h5") for split in stores}
    saved_read, saved_wandb = dm_module.read_store, sys.modules.get("wandb")
    if have["h5py"]:
        for split, s in stores.items():
            write_store(paths[split], s.inputs, s.targets, s.x, s.t)
    else:
        dm_module.read_store = {paths[split]: s for split, s in stores.items()}.__getitem__
    sys.modules["wandb"] = None
    job = ["system=swe_per", f"dataroot={root}", "trainer.max_epochs=1"]
    if not have["matplotlib"]:
        job.append("callbacks=callbacks_save_model")
    run_dir = os.path.join(root, "run")
    kernels.reset_launches()
    try:
        with CliProbe(DdimTask) as probe:
            t0 = time.perf_counter()
            run.main(["--config-name", DDIM_CLI_CONFIG] + job + [f"hydra.run.dir={run_dir}"])
            seconds = time.perf_counter() - t0
        launches = kernels.launches()
        vs_plain = cli_kernel_vs_plain(
            device, DDIM_CLI_CONFIG, job, run_dir, masked=False, need=DDPM_KERNELS,
            unheld=UNHELD_METRICS)
    finally:
        dm_module.read_store = saved_read
        if saved_wandb is None:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = saved_wandb
    recs = read_metrics(run_dir)
    keys = set().union(*map(set, recs))
    if keys != DDIM_METRIC_KEYS:
        raise AssertionError(f"metric keys {sorted(keys ^ DDIM_METRIC_KEYS)} differ "
                             f"from the JAX package's")
    for i, rec in enumerate(probe.steps):
        got = rec["launches"]
        fwd = got["K2 gn_silu_conv"] // DDPM_PER_FORWARD["K2 gn_silu_conv"]
        if fwd not in (1, 2):  # with or without the self-conditioning forward
            raise AssertionError(f"CLI train step {i}: launches {got}")
        expect_launches(got, DDPM_PER_FORWARD, fwd, f"CLI train step {i} forward")
        expect_launches(got, DDPM_BWD_PER_STEP, 1, f"CLI train step {i} backward")
    for i, rec in enumerate(probe.evals):
        expect_launches(rec["launches"], DDPM_PER_FORWARD, rec["forwards"],
                        f"CLI eval {i} ({rec['forwards']} forwards)")
    if len(probe.steps) != 2:
        raise AssertionError(f"{len(probe.steps)} train steps, expected 2")
    tests = [r for r in probe.evals if r["split"] == "test"]
    step_ms = [r["s"] * 1e3 for r in probe.steps]
    rec = {"phase": "ddim_cli", "config": DDIM_CLI_CONFIG, "nvidia_smi": nvidia_smi_line(),
           "data": "h5" if have["h5py"] else "in_memory",
           "callbacks": "configured" if have["matplotlib"] else "callbacks_save_model",
           "seconds": seconds, "train_step_ms": step_ms,
           "val_s": [r["s"] for r in probe.evals if r["split"] == "val"],
           "test_s": [r["s"] for r in tests],
           "test_samples_per_s": [r["samples"] / r["s"] for r in tests],
           "test_unet_forwards": [r["forwards"] for r in tests],
           "test_batch": [r["samples"] for r in tests],
           "test_metrics": {k: v for k, v in recs[-1].items() if k.startswith("test_")},
           "kernel_vs_plain": vs_plain, "launches": {k: v for k, v in launches.items() if v}}
    emit(rec)
    shutil.rmtree(root)
    return rec


# ---------------------------------------------------------------------------
# phase 14: the FNO (FnoStateReconstrTask and its CLI config) and the
# OFormer's time prediction (OformerTimePredTask on K5 / K6)
# ---------------------------------------------------------------------------

FNO_CLI_CONFIG = "config_fnostatereconstrabs2d.yaml"
# The metric keys the JAX package's run.main writes for the FNO config with
# one epoch, written down from one JAX run on tests/test_torch_cli.py's
# fixtures; tests/test_torch_cli.py holds the JAX run and the port's CLI on
# the CPU to this set
FNO_METRIC_KEYS = frozenset(
    {"epoch", "epoch_time_s", "time", "train_loss", "train_mae_u", "train_mae_u_un"}
    | {f"{split}_{k}" for split in ("val", "test")
       for k in ("corr", "loss", "mae_u", "mae_u_scaled", "mae_u_un", "pde_loss",
                 "pde_loss_gt")})
# The FNO in fp32 against the same FNO in float64 on the card, TF32 off:
# five layers, each six chained contractions of up to 132 terms plus a
# 32-channel 1x1 conv. The output to 1e-5 of its scale; the two spectral
# routes (truncated DFT as matmuls, rfft2) to each other to 2e-5 of scale;
# the two-stage test_step's metrics and output to 1e-4 (two FNOs chained,
# then the finite-volume residual)
TOL_FNO = 1e-5
TOL_FNO_ROUTES = 2e-5
TOL_FNO_STAGES = 1e-4
FNO_EVAL_RUNS = 3


def scaled_error(got, want, tol: float, name: str) -> dict:
    """max |got - want| over max |want| (the output's own scale); raises
    beyond tol."""
    import torch

    got, want = got.double(), want.double()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if err > tol * scale:
        raise AssertionError(f"{name}: error {err:.3e} of scale {scale:.3e} beyond {tol:.0e}")
    return {"max_abs_err": err, "scale": scale, "max_rel_err": err / scale, "tol": tol}


def float64_state(state):
    """A copy of an FNO TaskState in float64 (the normalizers stay fp32;
    their products with float64 tensors are float64)."""
    import dataclasses

    dbl = lambda d: {k: v.double() for k, v in d.items()}
    opt = state.opt_state
    return dataclasses.replace(state, params=dbl(state.params),
                               opt_state={"count": opt["count"], "mu": dbl(opt["mu"]),
                                          "nu": dbl(opt["nu"])})


def fno_data(device, b: int, seed: int):
    """Seeded synthetic shallow-water fields at T = X = FNO_RES, gauss-normalized
    as the abs-coord datamodule normalizes them, with its (B, X) and (B, T)
    coordinate rows: the batch (u, x, t, s) = (h, x, t, u) and its stats."""
    import torch

    h, _, _, u = synthetic_swe_batch(np.random.RandomState(seed), b, FNO_RES)
    stats = {"input_mean": h.mean(), "input_std": h.std(),
             "target_mean": u.mean(), "target_std": u.std()}
    x = np.tile(np.linspace(-0.5, 0.5, FNO_RES, dtype=np.float32), (b, 1))
    t = np.tile(np.linspace(0.0, 0.128, FNO_RES, dtype=np.float32), (b, 1))
    arrays = ((h - stats["input_mean"]) / stats["input_std"], x, t,
              (u - stats["target_mean"]) / stats["target_std"])
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
                 for a in arrays), stats


def fno_tasks(device, hparams, target=FNO_TARGET):
    """The task in fp32 and the same task with its model in float64."""
    from m_cedm_tpu_torch.tasks import build_task

    task, task64 = (build_task(hparams, device, target=target) for _ in range(2))
    for t in (task, task64):
        t.set_pde_loss_function("swe_per", False)
    for m in (task64.model_state.model, task64.model_time.model) if hasattr(
            task64, "model_state") else (task64.model,):
        m.double()
    return task, task64


def phase_fno(device, b: int) -> dict:
    """FnoStateReconstrTask of configs/model/fnostatereconstr2d.yaml at full
    width and depth (width 32, 5 layers, modes 12, padding_t 4) on B = 32
    seeded fields at T = X = 128: the forward against float64 with TF32
    turned on beforehand (the model must turn it off); the DFT route against
    the rfft2 route (module functions called directly on the first layer's
    padded input shape and weights), with their times; the eval's 7 metrics;
    3 train steps against float64; ms per train step and the eval's
    samples/s, one profiled step. Returns the state, batch and stats for
    phase 14d."""
    import torch

    from m_cedm_tpu_torch.models import fno as fno_model

    batch, stats = fno_data(device, b, SEED + 40)
    batch64 = tuple(a.double() for a in batch)
    task, task64 = fno_tasks(device, FNO_HPARAMS)
    state = task.init_state(torch.Generator().manual_seed(SEED + 41), stats)
    state64 = float64_state(state)

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    with torch.no_grad():
        pred = task._predict(state.params, *batch[:3])
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if any(tf32):
        raise AssertionError(f"TF32 (matmul, cudnn) {tf32} on after the FNO's forward")
    with torch.no_grad():
        pred64 = task64._predict(state64.params, *batch64[:3])
    if tuple(pred.shape) != (b, FNO_RES, FNO_RES, 1):
        raise AssertionError(f"FNO prediction shape {tuple(pred.shape)}")
    forward = scaled_error(pred, pred64, TOL_FNO, "FNO forward vs float64")

    # the two routes on the first spectral layer's input shape (the padded
    # 128 x 132 grid at width 32) with its weights
    g = torch.Generator(device=device).manual_seed(SEED + 42)
    cfg = task.cfg
    x = torch.randn(b, FNO_RES, FNO_RES + cfg.padding_t, cfg.width, generator=g,
                    device=device)
    w = [state.params[f"fourier_0.{n}"] for n in ("w1_real", "w1_imag", "w2_real", "w2_imag")]
    if not fno_model.dft_route(x.shape[1], x.shape[2], cfg.modes_1, cfg.modes_2):
        raise AssertionError("the shipped FNO shape must take the DFT route")
    with torch.no_grad():
        dft, fft = fno_model.spectral_conv_dft(x, *w), fno_model.spectral_conv_fft(x, *w)
        want64 = fno_model.spectral_conv_fft(x.double(), *(v.double() for v in w))
        routes = {"dft_vs_fft": scaled_error(dft, fft, TOL_FNO_ROUTES, "DFT route vs rfft2"),
                  "dft_vs_float64": scaled_error(dft, want64, TOL_FNO_ROUTES, "DFT route"),
                  "fft_vs_float64": scaled_error(fft, want64, TOL_FNO_ROUTES, "rfft2 route"),
                  "dft_ms": cuda_ms(lambda: fno_model.spectral_conv_dft(x, *w)),
                  "fft_ms": cuda_ms(lambda: fno_model.spectral_conv_fft(x, *w))}
    del x, dft, fft, want64

    metrics, _ = task.eval_step(state, batch, split="val")
    metrics = {k: float(v) for k, v in metrics.items()}
    want_keys = {k for k in FNO_METRIC_KEYS if k.startswith("val_")}
    if set(metrics) != want_keys or not all(map(math.isfinite, metrics.values())):
        raise AssertionError(f"FNO eval metrics {metrics}")
    metrics64 = {k: float(v) for k, v in task64.eval_step(state64, batch64)[0].items()}
    eval_s = []
    for _ in range(FNO_EVAL_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        task.eval_step(state, batch, split="val")
        torch.cuda.synchronize()
        eval_s.append(time.perf_counter() - t0)

    s32, s64, steps = state, state64, []
    for i in range(TRAIN_STEPS):
        s32, m32 = task.train_step(s32, batch)
        s64, m64 = task64.train_step(s64, batch64)
        for key in ("train_loss", "grad_norm"):
            a, want = float(m32[key]), float(m64[key])
            if not math.isfinite(a) or abs(a - want) > TOL_TRAIN * abs(want):
                raise AssertionError(f"FNO train step {i} {key}: fp32 {a} vs float64 {want}")
        steps.append({"fp32": {k: float(v) for k, v in m32.items()},
                      "float64": {k: float(v) for k, v in m64.items()}})
    lr = FNO_HPARAMS["lr"]
    diff = max(float((s32.params[k] - s64.params[k]).abs().max()) for k in s32.params)
    moved = max(float((s32.params[k] - state.params[k]).abs().max()) for k in s32.params)
    if not (diff <= 2 * lr * TRAIN_STEPS and moved > 0):
        raise AssertionError(f"FNO params after {TRAIN_STEPS} steps: {diff} from float64, "
                             f"moved {moved}")
    _, _, walls = train_steps(task, s32, batch, device, TRAIN_STEPS,
                              TRAIN_WARMUP + TRAIN_TIMED)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if any(tf32):
        raise AssertionError(f"TF32 (matmul, cudnn) {tf32} on during the FNO's steps")
    ms = float(np.median(walls[TRAIN_WARMUP:])) * 1e3
    eval_med = float(np.median(eval_s))
    emit({"phase": "fno", "config": "fnostatereconstr2d", "nvidia_smi": nvidia_smi_line(),
          "batch": b, "grid": [FNO_RES, FNO_RES], "padded": [FNO_RES, FNO_RES + cfg.padding_t],
          "forward_vs_float64": forward, "routes": routes,
          "tf32_during_fno": list(tf32),
          "eval_metrics": metrics, "eval_metrics_float64": metrics64,
          "eval_s": eval_s, "eval_samples_per_s": b / eval_med,
          "train": steps, "tol": TOL_TRAIN, "params_max_abs_diff": diff,
          "tol_params": 2 * lr * TRAIN_STEPS, "params_moved_max": moved,
          "step_ms": [w_ * 1e3 for w_ in walls], "ms_per_step": ms,
          "profile": profile_step(task, s32, batch, device, ms / 1e3)})
    return {"state": state, "batch": batch, "stats": stats}


def phase_fno_cli(device) -> dict:
    """config_fnostatereconstrabs2d.yaml through m_cedm_tpu_torch.run at full
    width and depth on phase 12's seeded fields (64 train and 16 test
    trajectories at res 128, served as in-memory stores where h5py is
    missing; system=swe_per, their grid): one epoch of 2 steps at batch 32
    with validation and the test, a resume to epoch 2, then
    m_cedm_tpu_torch.eval_model on the resumed run. Every logged metric
    finite, the keys the JAX package's (FNO_METRIC_KEYS), the resumed run
    trains epoch 1 only, eval_model's test metrics within 1e-4 of the
    run's, no kernel launched (the FNO runs none); seconds, ms per train
    step and the test's samples/s."""
    import importlib.util
    import os
    import shutil

    from m_cedm_tpu_torch import eval_model, kernels, run
    from m_cedm_tpu_torch.data import datamodule as dm_module
    from m_cedm_tpu_torch.data.h5_io import write_store
    from m_cedm_tpu_torch.tasks.fno import FnoStateReconstrTask

    have = {m: importlib.util.find_spec(m) is not None
            for m in ("h5py", "matplotlib", "wandb")}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "fno_cli")
    shutil.rmtree(root, ignore_errors=True)
    sub = os.path.join(root, "1D_swp_128_per")
    os.makedirs(sub)
    stores = cli_stores(FNO_RES)
    paths = {split: os.path.join(sub, f"1D_swp_128_per_{split}.h5") for split in stores}
    saved_read, saved_wandb = dm_module.read_store, sys.modules.get("wandb")
    if have["h5py"]:
        for split, st in stores.items():
            write_store(paths[split], st.inputs, st.targets, st.x, st.t)
    else:
        dm_module.read_store = {paths[split]: st for split, st in stores.items()}.__getitem__
    sys.modules["wandb"] = None
    job = ["--config-name", FNO_CLI_CONFIG, "system=swe_per", f"dataroot={root}"]
    if not have["matplotlib"]:
        job.append("callbacks=callbacks_save_model")
    run_dir, run2_dir, eval_dir = (os.path.join(root, d) for d in ("run", "run2", "eval"))
    secs = {}
    kernels.reset_launches()
    try:
        with CliProbe(FnoStateReconstrTask) as probe:
            for name, fn, extra in (
                    ("fit", run.main, ["trainer.max_epochs=1", f"hydra.run.dir={run_dir}"]),
                    ("resume", run.main, [f"ckpt_path={run_dir}", "trainer.max_epochs=2",
                                          f"hydra.run.dir={run2_dir}"]),
                    ("eval_model", eval_model.main, [f"ckpt_path={run2_dir}",
                                                     f"hydra.run.dir={eval_dir}"])):
                t0 = time.perf_counter()
                fn(job + extra)
                secs[name] = time.perf_counter() - t0
    finally:
        dm_module.read_store = saved_read
        if saved_wandb is None:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = saved_wandb
    launched = {k: v for k, v in kernels.launches().items() if v}
    if launched:
        raise AssertionError(f"the FNO's CLI launched {launched}")
    recs = {d: read_metrics(p) for d, p in (("run", run_dir), ("run2", run2_dir),
                                              ("eval", eval_dir))}
    for d in ("run", "run2"):
        keys = set().union(*map(set, recs[d]))
        if keys != FNO_METRIC_KEYS:
            raise AssertionError(f"{d} metric keys {sorted(keys ^ FNO_METRIC_KEYS)} differ "
                                 f"from the JAX package's")
    trained = sorted(r["epoch"] for r in recs["run2"] if "train_loss" in r)
    if trained != [1]:
        raise AssertionError(f"the resumed run trained epochs {trained}, expected [1]")
    run2_test = [r for r in recs["run2"] if "test_mae_u" in r][-1]
    (eval_test,) = recs["eval"]
    test_keys = {k for k in run2_test if k.startswith("test_")}
    if test_keys != {k for k in eval_test if k.startswith("test_")}:
        raise AssertionError(f"eval_model keys {sorted(eval_test)}")
    eval_err = {k: abs(eval_test[k] - run2_test[k]) / max(abs(run2_test[k]), 1e-30)
                for k in test_keys}
    if max(eval_err.values()) > TOL_CLI:
        raise AssertionError(f"eval_model vs the resumed run's test: {eval_err}")
    if len(probe.steps) != 4:
        raise AssertionError(f"{len(probe.steps)} train steps, expected 2 + 2")
    tests = [r for r in probe.evals if r["split"] == "test"]
    step_ms = [r["s"] * 1e3 for r in probe.steps]
    rec = {"phase": "fno_cli", "config": FNO_CLI_CONFIG, "nvidia_smi": nvidia_smi_line(),
           "data": "h5" if have["h5py"] else "in_memory",
           "callbacks": "configured" if have["matplotlib"] else "callbacks_save_model",
           "seconds": secs, "train_step_ms": step_ms,
           "val_s": [r["s"] for r in probe.evals if r["split"] == "val"],
           "test_s": [r["s"] for r in tests],
           "test_samples_per_s": [r["samples"] / r["s"] for r in tests],
           "eval_model_max_rel_err": max(eval_err.values()), "tol": TOL_CLI,
           "test_metrics": {k: run2_test[k] for k in sorted(test_keys)}}
    emit(rec)
    shutil.rmtree(root)
    return rec


def phase_two_stage(device, fno: dict, timepred_params, timepred_constants) -> dict:
    """The two two-stage test_steps. OformerStateTimePredTask: a fresh
    oformer_t reconstruction state and the time-prediction state of phase
    14c after its train steps, on seeded fields tokenized for both stages
    (the reconstruction's full grid, the prediction's split at 64), kernel
    path against plain path within 1e-4, launches asserted (one forward of
    each model: 2 x OFORMER_SITES of K5 and of K6). FnoStateTimePredTask:
    phase 14a's reconstruction weights (at time_history 64) and a fresh
    FnoTimePredTask's ((u, s) in and out; the second half of T = 128 from
    the first), fp32 against float64 within 1e-4 of scale, under both
    flip_xy (the fields and statistics swapped, as the datamodule swaps
    them)."""
    import torch

    from m_cedm_tpu_torch import kernels
    from m_cedm_tpu_torch.data.oformer_data import tokenize_grid
    from m_cedm_tpu_torch.tasks import build_task

    b = BATCH
    stats, tbatch, _, _ = oformer_setup(device, b, SEED + 50, TIMEPRED_HPARAMS,
                                        TIMEPRED_TARGET)
    # the same seed's fields, tokenized whole for the reconstruction stage
    _, rbatch, rparams, rconstants = oformer_setup(device, b, SEED + 50)
    hp = {"hparams_state": OFORMER_HPARAMS, "hparams_time": TIMEPRED_HPARAMS,
          "time_history": TIMEPRED_HISTORY}
    out = {}
    for path, ops in (("kernel", kernels.DEVICE_OPS), ("plain", kernels.PLAIN_OPS)):
        task = build_task(hp, device, target="m_cedm_tpu.tasks.OformerStateTimePredTask",
                          ops=ops)
        rs = task.model_state.init_state(None, stats, params=rparams, constants=rconstants)
        ts = task.model_time.init_state(None, stats, params=timepred_params,
                                        constants=timepred_constants)
        kernels.reset_launches()
        metrics, pred = task.test_step(rs, ts, rbatch, tbatch)
        out[path] = ({k: float(v) for k, v in metrics.items()}, pred, kernels.launches())
    (km, kpred, klaunch), (pm, ppred, plaunch) = out["kernel"], out["plain"]
    check_oformer_launches(klaunch, 2 * OFORMER_SITES, 2 * OFORMER_SITES,
                           "the two-stage OFormer test_step")
    check_oformer_launches(plaunch, 0, 0, "the plain two-stage OFormer test_step")
    for k, v in km.items():
        if not math.isfinite(v) or abs(v - pm[k]) > TOL_METRICS * max(1.0, abs(pm[k])):
            raise AssertionError(f"two-stage OFormer {k}: kernel {v} vs plain {pm[k]}")
    oformer = {"metrics": km, "plain_metrics": pm, "tol": TOL_METRICS,
               "prediction": compare(kpred, ppred, TOL_METRICS, "two-stage OFormer"),
               "launches": {k: klaunch[k] for k in OFORMER_KERNELS}}

    th = FNO_RES // 2  # the FNO predicts as many steps as it sees: the second half
    fhp = {"hparams_state": {**FNO_HPARAMS, "time_history": th},
           "hparams_time": {**FNO_HPARAMS, "time_history": th, "input_size": 2,
                            "state_size": 2}, "time_history": th}
    task, task64 = fno_tasks(device, fhp, "m_cedm_tpu.tasks.FnoStateTimePredTask")
    tparams = task.model_time.init_state(torch.Generator().manual_seed(SEED + 51)).params
    fno_out = {}
    for flip in (False, True):
        # flip_xy swaps the roles as the datamodule does: u observed, h hidden
        stats, batch = fno["stats"], fno["batch"]
        if flip:
            stats = {f"{a}_{m}": stats[f"{b_}_{m}"] for a, b_ in (("input", "target"),
                                                                  ("target", "input"))
                     for m in ("mean", "std")}
            batch = (batch[3], batch[1], batch[2], batch[0])
        rstate = task.model_state.init_state(None, stats, params=fno["state"].params)
        tstate = task.model_time.init_state(None, stats, params=tparams)
        for t in (task, task64):
            t.set_pde_loss_function("swe_per", flip)
        m32, p32 = task.test_step(rstate, tstate, batch)
        m64, p64 = task64.test_step(float64_state(rstate), float64_state(tstate),
                                    tuple(a.double() for a in batch))
        errs = {}
        for k, v in m64.items():
            a, want = float(m32[k]), float(v)
            errs[k] = abs(a - want) / abs(want)
            if not math.isfinite(a) or errs[k] > TOL_FNO_STAGES:
                raise AssertionError(f"two-stage FNO (flip_xy {flip}) {k}: fp32 {a} vs "
                                     f"float64 {want}")
        fno_out[f"flip_xy_{flip}"] = {
            "metrics": {k: float(v) for k, v in m32.items()}, "metrics_rel_err": errs,
            "output": scaled_error(p32, p64, TOL_FNO_STAGES, "two-stage FNO output")}
    rec = {"phase": "two_stage", "nvidia_smi": nvidia_smi_line(), "oformer": oformer,
           "fno": fno_out, "tol_fno": TOL_FNO_STAGES}
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 15: bf16 serving
# ---------------------------------------------------------------------------

# A bf16 kernel against its bf16 plain version: both sum in fp32 in other
# orders and round once to bf16, so they differ where that order flips an
# output's last bit (2^-8 of it): at most about 1e-2 of the output's scale,
# and rarely, so the mean stays under 1e-4 of scale. Emitted statistics come
# from the fp32 sums before the rounding: 1e-5 of their scale.
TOL_BF16 = 1e-2
TOL_BF16_MEAN = 1e-4
TOL_BF16_STATS = 1e-5
# The full bf16 forward, kernel path against the bf16 plain path: about 25
# chained layers, each of which can flip an ulp of its bf16 output
TOL_BF16_FORWARD = 2e-2
# The bf16 eval's metrics, kernel path against plain path (99 forwards whose
# outputs differ by the forward's flips)
TOL_BF16_METRICS = 2e-2
# one rounding to bf16: half an ulp, 2^-8 of the value, with room for the
# fp32 sum's own error
BF16_ROUNDING = 1.01 * 2.0 ** -8
BF16_RUNS = 2  # timed evals per path in phase 15, taken in turns
# the bf16 variants, by the summary line's name, and the fp32 kernel's name
# (its source and the TPU kernel it replaces; the wrapper counting both
# instances, but for K5's and K6's, which count apart: LINEAR_BF16)
BF16_KERNELS = {f"{name} bf16": name for name in (
    "K1 channel_stats", "K1 gn_silu", "K2 gn_silu_conv", "K2 narrow_conv",
    "K3 gn_silu_up_conv", "K4 attention", "K5 kv_dots", "K6 apply_dots")}


def bf16_error(got, want, name: str, stats: bool = False) -> dict:
    """max and mean |got - want| over the scale max|want|; raises beyond
    TOL_BF16 / TOL_BF16_MEAN (TOL_BF16_STATS for fp32 statistics)."""
    import torch

    if got.dtype != want.dtype:
        raise AssertionError(f"{name}: dtype {got.dtype}, plain {want.dtype}")
    got, want = got.double(), want.double()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    scale = max(float(want.abs().max()), 1e-30)
    mx, mean = float(err.max()) / scale, float(err.mean()) / scale
    tol, tol_mean = (TOL_BF16_STATS, TOL_BF16_STATS) if stats else (TOL_BF16, TOL_BF16_MEAN)
    if mx > tol or mean > tol_mean:
        raise AssertionError(f"{name}: error max {mx:.3e} mean {mean:.3e} of scale, "
                             f"beyond {tol:.0e} / {tol_mean:.0e}")
    return {"max_abs_err": float(err.max()), "max_rel_err": mx, "mean_rel_err": mean,
            "tol": tol, "tol_mean": tol_mean}


def bf16_conv_plan(x, o: int, *, up: bool = False, cr: int = 0, act: bool = True,
                   res_mode: int = 0, emit: bool = False) -> dict:
    """gnsc_bf16_kernel's launch plan for a K2 / K3 call on x (B, H, W, C)
    (H, W: the input's; K3 outputs twice them), from the CUDA source's
    mc_gn_silu_conv_bf16_plan: tile rows, weights resident (else streamed),
    blocks, dynamic shared memory, co-resident blocks an SM."""
    import ctypes

    from m_cedm_tpu_torch.kernels import _build

    b_, h_, w_, c_ = x.shape
    h_, w_ = (2 * h_, 2 * w_) if up else (h_, w_)
    fn = _build.bind("fused_norm_conv", "mc_gn_silu_conv_bf16_plan",
                     [ctypes.c_int] * 10 + [ctypes.c_void_p])
    out = (ctypes.c_int * 5)()
    rc = fn(int(up), b_, h_, w_, c_, o, cr, int(act), res_mode, int(emit), out)
    if rc:
        raise RuntimeError(f"mc_gn_silu_conv_bf16_plan failed with cudaError {rc}")
    return dict(zip(("tile_rows", "resident_weights", "blocks", "smem_bytes",
                     "blocks_per_sm"), list(out)))


# K1 gn_silu bf16's modes: its main-path sites (every one with chained
# statistics), then the own-statistics pass at C 128, on no bf16 path
APPLY_BF16_MODES = ("(B, 16384, 64): down norm0 at res 128 and out_norm",
                    "(B, 4096, 64): down norm0 at res 64",
                    "own stats pass, 128 channels (context: on no bf16 path)")


def phase_bf16_kernels(device, b: int, res: int, ch: int) -> dict:
    """Phase 15.1: every bf16 kernel against its bf16 plain version at the
    flagship's serving shapes, with times, bounds and the bf16 library call
    where one computes the same function; returns per-kernel summaries keyed
    by BF16_KERNELS' names (the first case of each is its summary case), but
    for K5's and K6's, which phase 17.1 measures."""
    import torch
    import torch.nn.functional as F

    from m_cedm_tpu_torch.kernels import fused_attention as fa
    from m_cedm_tpu_torch.kernels import fused_norm as fn
    from m_cedm_tpu_torch.kernels import fused_norm_conv as fnc
    from m_cedm_tpu_torch.models.layers import adm_groups

    bf = torch.bfloat16
    g = torch.Generator(device=device).manual_seed(SEED + 60)

    def rnd(*shape, scale=1.0, shift=0.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=device) * scale + shift).to(dtype)

    def fold(c):
        return (rnd(b, c, scale=0.3, shift=1.0, dtype=torch.float32),
                rnd(b, c, scale=0.3, dtype=torch.float32))

    def flat(t):
        return [u for s in t for u in flat(s)] if isinstance(t, tuple) else [t]

    results = {}

    def check(kernel, mode, got, want, k_fn, p_fn, work, lib_fn=None, plan=None,
              device_fn=None):
        """got/want: out, or (out, (sums, sumsq)), or (sums, sumsq) for K1's
        statistics; work: `bound`'s arguments; plan: the kernel's launch plan
        (K2 / K3); device_fn: timed on the card's clock as well
        (`device_ms`), where the wrapper's host cost exceeds the kernel's."""
        got, want = flat(got), flat(want)
        if len(got) != len(want):
            raise AssertionError(f"{kernel} {mode}: {len(got)} outputs, plain {len(want)}")
        stats_only = kernel.startswith("K1 channel_stats")
        errs = [bf16_error(a, w, f"{kernel} {mode} output {i}",
                           stats=stats_only or i > 0)
                for i, (a, w) in enumerate(zip(got, want))]
        out_err = errs[0]
        rec = {"phase": "bf16_kernel", "kernel": kernel, "mode": mode,
               "max_abs_err": out_err["max_abs_err"], "max_rel_err": out_err["max_rel_err"],
               "mean_rel_err": out_err["mean_rel_err"], "tol": out_err["tol"],
               "tol_mean": out_err["tol_mean"],
               "stats_max_rel_err": max((e["max_rel_err"] for e in errs[1:]), default=None),
               "ms": cuda_ms(k_fn), "plain_ms": cuda_ms(p_fn), **bound(*work),
               "library_ms": None}
        if device_fn is not None:
            rec["device_ms"] = device_ms(device_fn, bound(*work))
        if plan is not None:
            rec["plan"] = plan
        if lib_fn is not None:
            rec["library_ms"] = cuda_ms(lib_fn)
            lib = lib_fn().double()
            rec["library_max_rel_err"] = float((lib - want[0].double()).abs().max()
                                               / want[0].double().abs().max())
        emit(rec)
        prev = results.get(kernel)
        if prev is None:
            results[kernel] = dict(rec, modes=[])
        else:
            for k in ("max_abs_err", "max_rel_err", "mean_rel_err"):
                prev[k] = max(prev[k], rec[k])
        results[kernel]["modes"].append(
            {k: rec[k] for k in ("mode", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "max_rel_err", "mean_rel_err",
                                 "stats_max_rel_err", "plan") if k in rec})

    def conv_lib(x, w, bias):
        """bf16 conv2d (cuDNN) on the NHWC operands: the linear mode's and the
        narrow conv's function up to where it rounds."""
        return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), bias.to(bf),
                        padding=1).permute(0, 2, 3, 1)

    with torch.no_grad():
        n = res * res
        c = ch
        gr = adm_groups(c)
        x = rnd(b, n, c, scale=0.8, shift=0.2)
        gamma, beta = fold(c)
        # the main path's two shapes first (the summary mode), res 128 as
        # context (phase 2's STATS_MODES); each call twice for the same bits
        g_st = torch.Generator(device=device).manual_seed(SEED + 61)
        for mode, xs in ((STATS_MODES[0], x_stats(b, res, c, g_st, device, bf)),
                         (STATS_MODES[1], x_stats(b, res, 2 * c, g_st, device, bf)),
                         (STATS_MODES[2], x)):
            st = fn.channel_stats_plain(xs)
            got = fn.channel_stats(xs)
            again = fn.channel_stats(xs)
            if not all(torch.equal(a, a2) for a, a2 in zip(got, again)):
                raise AssertionError(f"K1 channel_stats bf16 {mode}: two calls differ")
            check("K1 channel_stats bf16", mode, got, st,
                  lambda xs=xs: fn.channel_stats(xs), lambda xs=xs: fn.channel_stats_plain(xs),
                  (nbytes(xs, *st), 3.0 * xs.numel()),
                  device_fn=lambda xs=xs: fn.channel_stats(xs))
        # the apply at its main-path sites, chained statistics (the summary
        # mode first), then with its own statistics pass at C 128 as context
        x_r64 = rnd(b, n // 4, c, scale=0.8, shift=0.2)
        for mode, xa in ((APPLY_BF16_MODES[0], x), (APPLY_BF16_MODES[1], x_r64)):
            sa = fn.channel_stats_plain(xa)
            want = fn.gn_silu_plain(xa, gamma, beta, gr, stats=sa)
            check("K1 gn_silu bf16", mode, fn.gn_silu(xa, gamma, beta, gr, stats=sa), want,
                  lambda xa=xa, sa=sa: fn.gn_silu(xa, gamma, beta, gr, stats=sa),
                  lambda xa=xa, sa=sa: fn.gn_silu_plain(xa, gamma, beta, gr, stats=sa),
                  (nbytes(xa, gamma, beta, *sa, want), 6.0 * xa.numel()),
                  device_fn=lambda xa=xa, sa=sa: fn.gn_silu(xa, gamma, beta, gr, stats=sa))
        x2 = rnd(b, n, 2 * c, scale=0.8, shift=0.2)
        g2, b2 = fold(2 * c)
        check("K1 gn_silu bf16", APPLY_BF16_MODES[2],
              fn.gn_silu(x2, g2, b2, adm_groups(2 * c)),
              fn.gn_silu_plain(x2, g2, b2, adm_groups(2 * c)),
              lambda: fn.gn_silu(x2, g2, b2, adm_groups(2 * c)),
              lambda: fn.gn_silu_plain(x2, g2, b2, adm_groups(2 * c)),
              (nbytes(x2, g2, b2, x2) + 16 * b * c, 6.0 * x2.numel()))

        def conv_w(ci, co):
            return rnd(3, 3, ci, co, scale=1.0 / math.sqrt(9 * ci))

        def k2(mode, x, gamma, beta, w, bias, r_=None, **kw):
            groups = adm_groups(x.shape[-1]) if gamma is not None else 0
            got = fnc.gn_silu_conv(x, gamma, beta, w, bias, groups, **kw)
            want = fnc.gn_silu_conv_plain(x, gamma, beta, w, bias, groups, **kw)
            b_, h_, w_, c_ = x.shape
            cr = kw["residual"].shape[-1] if kw.get("skip_w") is not None else 0
            work = (nbytes(x, gamma, beta, w, bias, *(kw.get("stats") or ()),
                              kw.get("residual"), kw.get("skip_w"), kw.get("skip_b"),
                              *flat(want)),
                    conv_flops(b_, h_, w_, c_, w.shape[-1])
                    + 2.0 * b_ * h_ * w_ * cr * w.shape[-1], 0, PEAK_BF16)
            res_mode = (0 if kw.get("residual") is None else 3 if cr else
                        2 if kw.get("res_up") else 1)
            check("K2 gn_silu_conv bf16", mode, got, want,
                  lambda: fnc.gn_silu_conv(x, gamma, beta, w, bias, groups, **kw),
                  lambda: fnc.gn_silu_conv_plain(x, gamma, beta, w, bias, groups, **kw),
                  work, lib_fn=None if gamma is not None else lambda: conv_lib(x, w, bias),
                  plan=bf16_conv_plan(x, w.shape[-1], cr=cr, act=gamma is not None,
                                      res_mode=res_mode,
                                      emit=bool(kw.get("emit_stats"))))

        h = rnd(b, res, res, ch, scale=0.8, shift=0.2)
        hstats = fn.channel_stats_plain(h.reshape(b, -1, ch))
        gamma, beta = fold(ch)
        w, bias = conv_w(ch, ch), rnd(ch, scale=0.3, dtype=torch.float32)
        res_id = rnd(b, res, res, ch)
        k2("identity (block tail), chained stats", h, gamma, beta, w, bias,
           residual=res_id, stats=hstats)
        k2("identity + own stats pass + emit_stats", h, gamma, beta, w, bias,
           residual=res_id, emit_stats=True)
        k2("identity_up, emit_stats", h, gamma, beta, w, bias,
           residual=rnd(b, res // 2, res // 2, ch), res_up=True, emit_stats=True)
        xc = rnd(b, res, res, 2 * ch, scale=0.8, shift=0.2)
        gc, bc = fold(2 * ch)
        k2("proj from 128-channel concat, emit_stats", h, gamma, beta, w, bias,
           residual=xc, skip_w=rnd(2 * ch, ch, scale=1.0 / math.sqrt(2 * ch)),
           skip_b=rnd(ch, scale=0.3, dtype=torch.float32), emit_stats=True)
        k2("128-channel input, emit_stats (decoder conv0)", xc, gc, bc,
           conv_w(2 * ch, ch), bias, emit_stats=True)
        k2("act=False, emit_stats (down-block conv0 at res/2)",
           rnd(b, res // 2, res // 2, ch, scale=0.8, shift=0.2), None, None,
           conv_w(ch, ch), bias, emit_stats=True)
        for r in (res // 2, res // 4):
            hr = rnd(b, r, r, ch, scale=0.8, shift=0.2)
            k2(f"identity at res {r}, chained stats", hr, gamma, beta, w, bias,
               residual=rnd(b, r, r, ch),
               stats=fn.channel_stats_plain(hr.reshape(b, -1, ch)))

        def narrow(mode, x, w, bias, emit_stats=False):
            """The narrow route's bf16 kernels (narrow_c_bf16_kernel at C <= 8,
            narrow_o_bf16_kernel at O <= 8): held to the plain version, the
            output and its statistics the same bits on a repeat, the
            card's time beside the wrapper's."""
            want = fnc.narrow_conv_plain(x, w, bias, emit_stats)
            b_, h_, w_, c_ = x.shape
            got = fnc.gn_silu_conv(x, None, None, w, bias, emit_stats=emit_stats)
            again = fnc.gn_silu_conv(x, None, None, w, bias, emit_stats=emit_stats)
            if not all(torch.equal(a, a2) for a, a2 in zip(flat(got), flat(again))):
                raise AssertionError(f"K2 narrow_conv bf16 {mode}: two calls differ")
            check("K2 narrow_conv bf16", mode, got, want,
                  lambda: fnc.gn_silu_conv(x, None, None, w, bias, emit_stats=emit_stats),
                  lambda: fnc.narrow_conv_plain(x, w, bias, emit_stats),
                  (nbytes(x, w, bias, *flat(want)),
                   conv_flops(b_, h_, w_, c_, w.shape[-1]), 0, PEAK_BF16),
                  lib_fn=lambda: conv_lib(x, w, bias),
                  device_fn=lambda: fnc.gn_silu_conv(x, None, None, w, bias,
                                                     emit_stats=emit_stats))

        narrow("out conv, C 64 -> O 2", h, conv_w(ch, 2),
               rnd(2, scale=0.3, dtype=torch.float32))
        narrow("conv_in, C 4 -> O 64, emit_stats", rnd(b, res, res, 4), conv_w(4, ch),
               bias, emit_stats=True)
        narrow("conv_in, C 2 -> O 64, emit_stats (adm_edm_cond_h)", rnd(b, res, res, 2),
               conv_w(2, ch), bias, emit_stats=True)
        narrow("out conv, C 64 -> O 1 (adm_edm_cond_h)", h, conv_w(ch, 1),
               rnd(1, scale=0.3, dtype=torch.float32))
        results["K2 narrow_conv bf16"]["sass"] = narrow_bf16_sass()
        emit({"phase": "bf16_kernel", "kernel": "K2 narrow_conv bf16",
              "sass": results["K2 narrow_conv bf16"]["sass"]})

        xl = rnd(b, res // 2, res // 2, ch, scale=0.8, shift=0.2)
        xl_stats = fn.channel_stats_plain(xl.reshape(b, -1, ch))
        want = fnc.gn_silu_up_conv_plain(xl, gamma, beta, w, bias, gr, stats=xl_stats,
                                         emit_stats=True)
        check("K3 gn_silu_up_conv bf16", "up block conv0, chained stats + emit_stats",
              fnc.gn_silu_up_conv(xl, gamma, beta, w, bias, gr, stats=xl_stats,
                                  emit_stats=True), want,
              lambda: fnc.gn_silu_up_conv(xl, gamma, beta, w, bias, gr, stats=xl_stats,
                                          emit_stats=True),
              lambda: fnc.gn_silu_up_conv_plain(xl, gamma, beta, w, bias, gr,
                                                stats=xl_stats, emit_stats=True),
              (nbytes(xl, gamma, beta, w, bias, *xl_stats, *flat(want)),
               conv_flops(b, res, res, ch, ch), 0, PEAK_BF16),
              plan=bf16_conv_plan(xl, ch, up=True, emit=True))

        # K4 at the 32x32 sites. The bound is the least work that keeps fp32
        # accuracy (k4_bf16_bound): q k^T one bf16 product, P V, whose P is
        # fp32, three (P in three bf16 pieces); the SASS of the built
        # library shows every product on wgmma
        L = (res // 4) ** 2
        q, k, v = (rnd(b, L, 64) for _ in range(3))
        want = fa.attention_plain(q, k, v)

        def sdpa_bf16():
            return F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None])[:, 0]

        work, tf32_work = k4_bf16_bound(nbytes(q, k, v, want), 2.0 * b * L * L * 64, 1, 1)
        check("K4 attention bf16", "(N, L, D)", fa.attention(q, k, v), want,
              lambda: fa.attention(q, k, v), lambda: fa.attention_plain(q, k, v), work,
              lib_fn=sdpa_bf16, device_fn=lambda: fa.attention(q, k, v))
        results["K4 attention bf16"].update(bound_tf32_ms=bound(*tf32_work)["bound_ms"],
                                            sass=k4_bf16_sass("attention_fwd_bf16"))
        emit({"phase": "bf16_kernel", "kernel": "K4 attention bf16",
              **{k: results["K4 attention bf16"][k] for k in ("bound_tf32_ms", "sass")}})
    return results


def k4_bf16_bound(nbytes_: float, flops: float, exact: int, split: int):
    """`bound`'s arguments for the bf16 K4: `exact` products of two bf16
    operands (q k^T, g v^T) of `flops` each, and `split` with an fp32 P or
    dS. The first is the least work that keeps fp32 accuracy: a bf16 product
    each, three for a split one (P in three bf16 pieces that sum back to it,
    as the kernels run them), all at the bf16 rate. The second is the
    TF32-split bound of PRs 15-18 (a split product as two TF32 products),
    recorded beside as `bound_tf32_ms` so the earlier rows stay comparable."""
    return ((nbytes_, 3 * split * flops, 0, PEAK_BF16, exact * flops),
            (nbytes_, split * flops, 2, PEAK_FLOPS, exact * flops))


def narrow_bf16_sass() -> dict:
    """HMMA counts of the built narrow_conv library's bf16 forward kernels;
    raises unless each puts its products on the tensor cores."""
    from m_cedm_tpu_torch.kernels import _build

    counts = {}
    for name, c in _build.sass_counts("narrow_conv", "bf16_kernel").items():
        short = re.search(r"(narrow_[co]_bf16_kernel)I(\w+?)EEvN", name)
        counts[f"{short[1]}<{short[2]}>" if short else name] = c["HMMA"]
    if not counts or not all(counts.values()):
        raise AssertionError(f"bf16 narrow kernels: HMMA counts {counts}: every product "
                             "should be an mma.sync")
    return counts


def k4_bf16_sass(contains: str) -> dict:
    """HGMMA / HMMA counts of the built fused_attention library's bf16
    kernels whose name holds `contains`; raises unless each issues wgmma and
    no mma.sync."""
    from m_cedm_tpu_torch.kernels import _build

    counts = {}
    for name, c in _build.sass_counts("fused_attention", "_bf16_kernel").items():
        short = re.search(r"\d(attention_\w+?_kernel)(?:ILi(\d+)EE)?", name)
        if contains in name:
            counts[short[1] + (f"<{short[2]}>" if short[2] else "")] = c
    if not counts or any(c["HGMMA"] == 0 or c["HMMA"] for c in counts.values()):
        raise AssertionError(f"bf16 K4 kernels {contains}: SASS counts {counts}: "
                             "every product should be a wgmma")
    return counts


# the bf16 K4's keys beside the contract's in the `kernels` line (with the
# device time that phases 15.1 and 16.1 record for every kernel they time so)
K4_BF16_KEYS = ("device_ms", "bound_tf32_ms", "sass")

BF16_FORWARD_KERNELS = ("K1 channel_stats", "K1 gn_silu", "K2 gn_silu_conv",
                        "K2 narrow_conv", "K3 gn_silu_up_conv", "K4 attention")


def bf16_hparams(hparams) -> dict:
    hp = json.loads(json.dumps(hparams))
    hp["model"]["dtype"] = "bfloat16"
    return hp


def phase_bf16_forward(device, hparams, params, b: int) -> dict:
    """Phase 15.2: the full-width U-Net forward in bf16 through a bf16
    McedmTask's net_apply (params cast once, x and cond in bf16, the output
    in fp32), kernel path against the bf16 plain path, and its gap to the
    fp32 kernel path's forward."""
    import torch

    from m_cedm_tpu_torch import kernels
    from m_cedm_tpu_torch.tasks import build_task

    hp = bf16_hparams(hparams)
    r = hp["model"]["resolution"]
    rs = np.random.RandomState(SEED + 61)
    x, cond = (torch.from_numpy(rs.randn(b, r, r, 2).astype(np.float32)).to(device)
               for _ in range(2))
    sigma = torch.from_numpy(rs.uniform(-1.5, 1.0, b).astype(np.float32)).to(device)
    outs, ms, prof = {}, {}, {}
    for name, h, ops in (("kernel", hp, kernels.DEVICE_OPS), ("plain", hp, kernels.PLAIN_OPS),
                         ("fp32_kernel", hparams, kernels.DEVICE_OPS)):
        task = build_task(h, device, ops=ops)
        state = task.init_state(None, None, params=params)
        p = task._sample_params(state)
        with torch.no_grad():
            outs[name] = task.net_apply(p, x, sigma, cond)
            ms[name] = cuda_ms(lambda: task.net_apply(p, x, sigma, cond), 5)
            if name != "plain":
                prof[name] = profile_forward(lambda: task.net_apply(p, x, sigma, cond),
                                             ms[name])
    got, want = outs["kernel"], outs["plain"]
    if got.dtype != torch.float32 or tuple(got.shape) != (b, r, r, 2):
        raise AssertionError(f"bf16 forward output {got.dtype} {tuple(got.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError("bf16 forward: non-finite output")
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    if err > TOL_BF16_FORWARD:
        raise AssertionError(f"bf16 forward, kernel vs plain: {err:.3e} of scale")
    fp32 = outs["fp32_kernel"]
    mean = float((got - want).abs().mean()) / scale
    # the mean gaps: kernel vs plain under the plain bf16 forward's own gap
    # to fp32, and the kernel path's gap to fp32 at least half of it, which a
    # path that computed in fp32 would not have
    bf16_gap = float((want - fp32).abs().mean() / fp32.abs().max())
    fp32_gap = float((got - fp32).abs().mean() / fp32.abs().max())
    if not mean < bf16_gap or not fp32_gap >= 0.5 * bf16_gap:
        raise AssertionError(f"bf16 forward mean gaps: kernel vs plain {mean:.3e}, "
                             f"kernel vs fp32 {fp32_gap:.3e}, plain vs fp32 {bf16_gap:.3e}")
    rec = {"phase": "bf16_forward", "shape": list(got.shape), "max_rel_err": err,
           "mean_rel_err": mean, "tol": TOL_BF16_FORWARD,
           "mean_rel_err_limit": bf16_gap, "plain_vs_fp32_kernel_mean_rel": bf16_gap,
           "vs_fp32_kernel_max_rel": float((got - fp32).abs().max() / fp32.abs().max()),
           "vs_fp32_kernel_mean_rel": fp32_gap,
           "ms": ms["kernel"], "plain_ms": ms["plain"], "fp32_kernel_ms": ms["fp32_kernel"],
           "profile": prof["kernel"], "fp32_profile": prof["fp32_kernel"]}
    emit(rec)
    return rec


def profile_forward(fn, ms: float) -> dict:
    """Device time and launches of one forward under torch.profiler; the idle
    share is taken against `ms`, the unprofiled forward's time (CUDA events
    around back-to-back forwards, so the host's pace when it is the slower)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, n = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            n += 1
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_busy_ms": busy_us / 1e3, "device_ops": n,
            "idle_share_vs_unprofiled": 1.0 - busy_us / 1e3 / ms,
            "share_by_kernel": {name: us / busy_us for name, us in top}}


def phase_bf16_matmul_flag(device) -> dict:
    """Phase 15.4, with torch.backends.cuda.matmul.allow_bf16_reduced_precision_
    reduction turned on before the model runs (main does so): the model's
    glue matmuls (layers.matmul, and the attention site's qkv and proj, 1x1
    Conv2d) still accumulate in fp32. A bf16 product with fp32 sums differs
    from float64's by its one rounding, at most half a bf16 ulp (2^-8 of the
    value, so of the scale), plus fp32 sums' error; torch.matmul in bf16
    with the flag on is timed and measured beside, as context."""
    import torch

    from m_cedm_tpu_torch.models.layers import Conv2d, matmul

    if not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction:
        raise AssertionError("the reduced-precision-reduction flag is off")
    g = torch.Generator(device=device).manual_seed(SEED + 62)
    rec = {"phase": "bf16_matmul_flag", "flag": True}
    for k in (64, 8192):  # the qkv's depth, and a depth where split-K reduces
        x = torch.randn(16 * 1024, k, generator=g, device=device).to(torch.bfloat16)
        w = (torch.randn(k, 192, generator=g, device=device) / math.sqrt(k)).to(torch.bfloat16)
        ref = x.double() @ w.double()
        scale = float(ref.abs().max())
        conv = Conv2d(k, 192, 1).to(device)
        with torch.no_grad():
            conv.weight.copy_(w.float())
            conv.bias.zero_()
            layer = conv(x.reshape(16, 32, 32, k)).reshape(-1, 192)
        errs = {name: float((y.double() - ref).abs().max()) / scale
                for name, y in (("layers.matmul", matmul(x, w)), ("Conv2d 1x1", layer),
                                ("torch.matmul bf16 (context)", x @ w))}
        for name in ("layers.matmul", "Conv2d 1x1"):
            if errs[name] > BF16_ROUNDING:
                raise AssertionError(f"K {k}: {name} error {errs[name]:.3e} of scale: "
                                     "not fp32 accumulation")
        rec[f"K_{k}"] = {"max_rel_err": errs, "bound": BF16_ROUNDING,
                         "ms": cuda_ms(lambda: matmul(x, w)),
                         "torch_matmul_bf16_ms": cuda_ms(lambda: x @ w)}
    emit(rec)
    return rec


def phase_bf16_eval(device, hparams, params, b: int, fp32_launches: dict) -> dict:
    """Phase 15.3: the flagship's eval (phase 4's batch, mask and noise) with
    model.dtype bfloat16, kernel path against the bf16 plain path; launches
    per eval asserted equal to phase 4's; samples/s of the bf16 eval and the
    fp32 per-conv eval, in turns. Returns the bf16 eval's launches and its
    launches per U-Net forward."""
    import torch

    from m_cedm_tpu_torch import kernels
    from m_cedm_tpu_torch.tasks import build_task

    hp = bf16_hparams(hparams)
    r = hp["model"]["resolution"]
    batch, mask, stats = flagship_eval_data(device, hp, b)
    task = build_task(hp, device)
    state = task.init_state(None, stats, params=params)
    task.model.calls = 0
    kernels.reset_launches()
    metrics, hu, wall = run_eval(task, state, batch, mask, device)
    launches, calls = kernels.launches(), task.model.calls
    if tuple(hu.shape) != (b, r, r, 2) or hu.dtype != torch.float32 \
            or not torch.isfinite(hu).all():
        raise AssertionError(f"bf16 eval output {hu.dtype} {tuple(hu.shape)} not finite")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"bf16 eval: non-finite metrics {metrics}")
    gt = task.transform.forward(state, batch[0], batch[3])
    known_err = float((hu[..., 0] - gt[..., 0]).abs().max())
    if known_err > TOL_KNOWN:
        raise AssertionError(f"bf16 eval: observed channel moved by {known_err}")
    got = {k: launches[k] for k in BF16_FORWARD_KERNELS}
    want = {k: fp32_launches[k] for k in BF16_FORWARD_KERNELS}
    if got != want or any(v for k, v in launches.items() if k not in BF16_FORWARD_KERNELS):
        raise AssertionError(f"bf16 eval launches {launches}, phase 4's {want}")

    ptask = build_task(hp, device, ops=kernels.PLAIN_OPS)
    pmetrics, phu, _ = run_eval(ptask, ptask.init_state(None, stats, params=params),
                                batch, mask, device)
    ftask = build_task(hparams, device)
    fstate = ftask.init_state(None, stats, params=params)
    _, fhu, fwall = run_eval(ftask, fstate, batch, mask, device)
    gaps = {"kernel_vs_plain": float((hu - phu).abs().mean()),
            "bf16_vs_fp32": float((hu - fhu).abs().mean())}
    if not gaps["kernel_vs_plain"] < gaps["bf16_vs_fp32"]:
        raise AssertionError(f"bf16 eval sample gaps {gaps}")
    rel = {}
    for k, v in metrics.items():
        rel[k] = abs(v - pmetrics[k]) / max(abs(pmetrics[k]), 1e-30)
        unheld = k.startswith("test_pde_loss") and not k.endswith("_gt")
        if not unheld and rel[k] > TOL_BF16_METRICS:
            raise AssertionError(f"bf16 {k}: kernel path {v} vs plain path {pmetrics[k]}")
    walls, fwalls = [wall], [fwall]
    for i in range(BF16_RUNS):  # in turns: bf16, fp32, bf16, fp32
        walls.append(run_eval(task, state, batch, mask, device)[2])
        fwalls.append(run_eval(ftask, fstate, batch, mask, device)[2])
    n = hp["sampler"]["n_samples"]
    wall, fwall = float(np.median(walls)), float(np.median(fwalls))
    per_forward = {k: launches[k] / calls for k in BF16_FORWARD_KERNELS}
    emit({"phase": "bf16_eval", "mask": "u", "batch": b, "nvidia_smi": nvidia_smi_line(),
          "steps": hp["sampler"]["timesteps"], "S_churn": hp["sampler"]["S_churn"],
          "unet_forwards": calls, "metrics": metrics, "plain_metrics": pmetrics,
          "metrics_rel_diff": rel, "metrics_tol": TOL_BF16_METRICS,
          "unheld": [k for k in metrics if k.startswith("test_pde_loss")
                     and not k.endswith("_gt")],
          "known_channel_max_err": known_err, "sample_mean_abs_gaps": gaps,
          "launches": launches, "launches_per_forward": per_forward,
          "wall_s": walls, "fp32_wall_s": fwalls,
          "samples_per_s": b * n / wall, "fp32_samples_per_s": b * n / fwall})
    return {"launches": launches, "per_forward": per_forward, "metrics": metrics}


def phase_bf16_cli(device, run2_dir: str, eval_dir: str, per_forward: dict) -> dict:
    """Phase 15.5: m_cedm_tpu_torch.eval_model with the JAX package's bf16
    override on phase 12's resumed run (its checkpoint, and its data: the
    h5 files, or the same seeded in-memory stores): the metric keys of
    phase 12's fp32 eval_model, every metric finite, the launches per U-Net
    forward equal to part 3's, and its seconds. Removes phase 12's
    directory."""
    import importlib.util
    import os
    import shutil

    from m_cedm_tpu_torch import eval_model, kernels
    from m_cedm_tpu_torch.data import datamodule as dm_module

    root = os.path.dirname(run2_dir)
    res = FLAGSHIP_HPARAMS["model"]["resolution"]
    sub = os.path.join(root, "1D_swp_128_per")
    saved_read, saved_wandb = dm_module.read_store, sys.modules.get("wandb")
    if importlib.util.find_spec("h5py") is None:
        by_path = {os.path.join(sub, f"1D_swp_128_per_{split}.h5"): s
                   for split, s in cli_stores(res).items()}
        dm_module.read_store = by_path.__getitem__
    sys.modules["wandb"] = None
    job = ["system=swe_per", f"dataroot={root}"]
    if importlib.util.find_spec("matplotlib") is None:
        job.append("callbacks=callbacks_save_model")
    bf16_dir = os.path.join(root, "eval_bf16")
    kernels.reset_launches()
    try:
        with CliProbe() as probe:
            t0 = time.perf_counter()
            eval_model.main(["--config-name", CLI_CONFIG] + job + [
                f"ckpt_path={run2_dir}", f"hydra.run.dir={bf16_dir}",
                "+model.hparams.model.dtype=bfloat16"])
            secs = time.perf_counter() - t0
    finally:
        dm_module.read_store = saved_read
        if saved_wandb is None:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = saved_wandb
    (got,) = read_metrics(bf16_dir)
    (fp32,) = read_metrics(eval_dir)
    if set(got) - {"time"} != set(fp32) - {"time"}:
        raise AssertionError(f"bf16 eval_model keys {sorted(set(got) ^ set(fp32))}")
    for i, rec in enumerate(probe.evals):
        per = {k: rec["launches"][k] / rec["forwards"] for k in BF16_FORWARD_KERNELS}
        if per != per_forward:
            raise AssertionError(f"bf16 eval_model eval {i}: launches per forward {per}, "
                                 f"part 3's {per_forward}")
    if not probe.evals:
        raise AssertionError("bf16 eval_model ran no eval")
    rec = {"phase": "bf16_cli", "config": CLI_CONFIG,
           "override": "+model.hparams.model.dtype=bfloat16", "seconds": secs,
           "metrics": got, "fp32_eval_model_metrics": fp32,
           "evals": [{k: r[k] for k in ("split", "forwards", "samples", "s")}
                     for r in probe.evals],
           "launches_per_forward": per_forward}
    emit(rec)
    shutil.rmtree(root)
    return rec


# Phase 15.6-15.8: the megakernel path in bf16. K7's emitted statistics sum
# conv1's fp32 output over an h that both sides round to bf16 from fp32 sums
# taken in another order (wgmma's, cuDNN's), so h's one-ulp flips reach
# them; the per-conv path's bf16 K2 / K3 on the same inputs are as far from
# the same plain version (1.85e-5 of scale at the up block, the largest;
# kernels/attention_sources.py --kernel k7bf16, one H100). TOL_MEGA doubles
# TOL_KERNEL for the same two chained convs in fp32; so here
TOL_MEGA_BF16_STATS = 4e-5
MEGA_BF16 = "K7 unet_block bf16"


def k7_bf16_sass() -> dict:
    """HGMMA / HMMA / UTMALDG / UTMASTG counts of the built fused_block
    library's bf16 K7 instances: the TMA route's four
    (unet_block_bf16_tma_kernel<up, kM, warpgroups>) and the kept route's
    four (unet_block_bf16_kernel<up, kM>); raises unless each issues wgmma
    and no mma.sync, and each TMA instance TMA loads and stores."""
    from m_cedm_tpu_torch.kernels import _build

    counts = {}
    for name, cnt in _build.sass_counts("fused_block", "unet_block_bf16").items():
        tma = re.search(r"(unet_block_bf16_tma_kernel)ILb([01])ELi([12])ELi([24])E", name)
        kept = re.search(r"(unet_block_bf16_kernel)ILb([01])ELi([12])E", name)
        short = (f"{tma[1]}<{tma[2]}, {tma[3]}, {tma[4]}>" if tma else
                 f"{kept[1]}<{kept[2]}, {kept[3]}>" if kept else name)
        counts[short] = cnt
        if (cnt["HGMMA"] == 0 or cnt["HMMA"]
                or (tma and (cnt["UTMALDG"] == 0 or cnt["UTMASTG"] == 0))):
            raise AssertionError(f"bf16 K7 {short}: SASS counts {cnt}: every product "
                                 "should be a wgmma, the TMA route's copies TMA's")
    if len(counts) != 8:
        raise AssertionError(f"bf16 K7: {len(counts)} instances in the SASS, not 8: {counts}")
    return counts


def phase_bf16_mega_kernel(device, b: int, res: int, ch: int) -> dict:
    """Phase 15.6: the bf16 K7 called through its wrapper against its bf16
    plain version at the flagship's widths (kernels/attention_sources.py's
    k7_bf16_cases: the identity block at res 128, 64 and 32, the decoder's
    dual input with its projection, the up block, the ragged case whose
    conv0 weights stream; every case with chained statistics and emitting):
    outputs within TOL_BF16 / TOL_BF16_MEAN, statistics within
    TOL_MEGA_BF16_STATS, the same bits on a repeat; kernel (wrapper and the
    card's clock), plain and bf16 two-kernel-path times, the bf16 bound, the
    launch plan; the built kernels' SASS (every product a wgmma). Returns
    the summary keyed MEGA_BF16 (the first case's times)."""
    import torch

    from m_cedm_tpu_torch.kernels import _build
    from m_cedm_tpu_torch.kernels import fused_block as fb
    from m_cedm_tpu_torch.kernels.attention_sources import (k7_bf16_cases,
                                                            k7_bf16_per_forward)

    modes, first = [], None
    for mode, (args, kw) in k7_bf16_cases(device, b, res, ch, SEED + 62).items():
        with torch.no_grad():
            want = fb.fused_unet_block_plain(*args, **kw)
            got = fb.fused_unet_block(*args, **kw)
            again = fb.fused_unet_block(*args, **kw)
            flat_got, flat_want = [got[0], *got[1]], [want[0], *want[1]]
            if not all(torch.equal(a, c) for a, c in zip(flat_got, [again[0], *again[1]])):
                raise AssertionError(f"bf16 K7 {mode}: a repeat gave other bits")
            err = bf16_error(flat_got[0], flat_want[0], f"bf16 K7 {mode} output")
            stats_err = []
            for i in (1, 2):
                g_, w_ = flat_got[i].double(), flat_want[i].double()
                rel = float((g_ - w_).abs().max()) / max(float(w_.abs().max()), 1e-30)
                if rel > TOL_MEGA_BF16_STATS:
                    raise AssertionError(f"bf16 K7 {mode} statistics {i}: {rel:.3e} of "
                                         f"scale beyond {TOL_MEGA_BF16_STATS:.0e}")
                stats_err.append(rel)
            two = two_kernel_block(*args, **kw)
            two_err = [float((a.double() - w.double()).abs().max())
                       / max(float(w.double().abs().max()), 1e-30)
                       for a, w in zip([two[0], *two[1]], flat_want)]
            x, x2 = args[0], kw.get("x2")
            bb, hh, ww, c1 = x.shape
            hh, ww = (2 * hh, 2 * ww) if kw["up"] else (hh, ww)
            c, o = args[3].shape[2], args[3].shape[3]
            proj = kw.get("skip_w") is not None
            flops = (conv_flops(bb, hh, ww, c, o) + conv_flops(bb, hh, ww, o, o)
                     + (2.0 * bb * hh * ww * c * o if proj else 0.0))
            work = bound(nbytes(*[a for a in args if torch.is_tensor(a)], x2,
                                kw.get("skip_w"), kw.get("skip_b"), *kw["stats"],
                                *flat_want), flops, 0, PEAK_BF16)
            c2 = x2.shape[-1] if x2 is not None else 0
            res0, res1, smem, bps, _, blocks, rows, tma, stages, wgs = fb._bf16_plan(
                bb, hh, ww, c1, c2, o, kw["up"], proj)
            rec = {"phase": "bf16_mega_kernel", "kernel": MEGA_BF16, "mode": mode,
                   "nvidia_smi": nvidia_smi_line(), **err,
                   "stats_max_rel_err": max(stats_err), "stats_tol": TOL_MEGA_BF16_STATS,
                   "same_bits_on_repeat": True,
                   "two_kernel_path_max_rel_err": two_err[0],
                   "two_kernel_path_stats_max_rel_err": max(two_err[1:]),
                   "ms": cuda_ms(lambda: fb.fused_unet_block(*args, **kw)),
                   "device_ms": device_ms(lambda: fb.fused_unet_block(*args, **kw), work),
                   "plain_ms": cuda_ms(lambda: fb.fused_unet_block_plain(*args, **kw)),
                   "two_kernel_ms": cuda_ms(lambda: two_kernel_block(*args, **kw)),
                   "two_kernel_device_ms": device_ms(lambda: two_kernel_block(*args, **kw),
                                                     work),
                   **work, "library_ms": None,
                   "library": "none: no PyTorch call computes a whole ADM block",
                   "route": ("unet_block_bf16_tma_kernel (TMA)" if tma else
                             "unet_block_bf16_kernel (cp.async, kept)"),
                   "plan": {"tile_rows": rows, "weights_resident_phase0": res0,
                            "weights_resident_phase1": res1, "ring_stages": stages,
                            "consumer_warpgroups": wgs,
                            "smem_bytes": smem, "blocks_per_sm": bps, "blocks": blocks,
                            "items": fb.grid(bb, hh, ww, o, kw["up"], torch.bfloat16,
                                             c1=c1, c2=c2, proj=proj)[0]}}
        emit(rec)
        modes.append({k: rec[k] for k in (
            "mode", "max_rel_err", "mean_rel_err", "stats_max_rel_err", "ms", "device_ms",
            "plain_ms", "two_kernel_ms", "two_kernel_device_ms", "bound_ms", "bound_by",
            "two_kernel_path_max_rel_err", "two_kernel_path_stats_max_rel_err", "route",
            "plan")})
        if first is None:
            first = dict(rec)
        for k in ("max_abs_err", "max_rel_err", "mean_rel_err", "stats_max_rel_err"):
            first[k] = max(first[k], rec[k])
        del want, got, again, two
    counts = k7_bf16_sass()
    # a forward's K7 time: each launch kind's device time times its launches
    per = k7_bf16_per_forward(res, ch)
    by_mode = {m["mode"]: m for m in modes}
    first.update(per_forward={k: {"launches": n, "device_ms": by_mode[k]["device_ms"],
                                  "two_kernel_device_ms": by_mode[k]["two_kernel_device_ms"],
                                  "bound_ms": by_mode[k]["bound_ms"]} for k, n in per.items()},
                 device_ms_per_forward=sum(n * by_mode[k]["device_ms"] for k, n in per.items()),
                 two_kernel_device_ms_per_forward=sum(
                     n * by_mode[k]["two_kernel_device_ms"] for k, n in per.items()),
                 bound_ms_per_forward=sum(n * by_mode[k]["bound_ms"] for k, n in per.items()))
    first.update(modes=modes, sass=counts, ptxas=[
        ln.strip() for ln in _build.build_log("fused_block").splitlines()
        if any(k in ln for k in ("unet_block_bf16", "registers", "spill"))])
    emit({"phase": "bf16_mega_kernel", "kernel": MEGA_BF16, "sass": counts,
          "ptxas": first["ptxas"], "device_ms_per_forward": first["device_ms_per_forward"],
          "two_kernel_device_ms_per_forward": first["two_kernel_device_ms_per_forward"],
          "bound_ms_per_forward": first["bound_ms_per_forward"]})
    torch.cuda.empty_cache()
    return {MEGA_BF16: first}


def phase_bf16_mega_eval(device, hparams, params, b: int, fp32_mega_launches: dict,
                         bf16_metrics: dict) -> dict:
    """Phase 15.7: the flagship eval of phase 15.3 (phase 4's batch and mask,
    the same noise) in bf16 with mega=True: metrics within TOL_BF16_METRICS
    of the bf16 per-conv eval's (test_pde_loss_u reported), h within 1e-5 of
    the truth, every kernel's launches equal to the fp32 mega eval's (phase
    10: 13 K7 a forward), samples/s of the bf16 mega and per-conv evals in
    turns. Returns the launches."""
    import torch

    from m_cedm_tpu_torch import kernels
    from m_cedm_tpu_torch.tasks import build_task

    hp = bf16_hparams(hparams)
    r = hp["model"]["resolution"]
    batch, mask, stats = flagship_eval_data(device, hp, b)
    task = build_task(hp, device, mega=True)
    state = task.init_state(None, stats, params=params)
    task.model.calls = 0
    kernels.reset_launches()
    metrics, hu, wall = run_eval(task, state, batch, mask, device)
    launches, calls = kernels.launches(), task.model.calls
    if tuple(hu.shape) != (b, r, r, 2) or not torch.isfinite(hu).all():
        raise AssertionError(f"bf16 mega eval output {tuple(hu.shape)} not finite")
    gt = task.transform.forward(state, batch[0], batch[3])
    known_err = float((hu[..., 0] - gt[..., 0]).abs().max())
    if known_err > TOL_KNOWN:
        raise AssertionError(f"bf16 mega eval: observed channel moved by {known_err}")
    if launches != fp32_mega_launches or launches["K7 unet_block"] != 13 * calls:
        raise AssertionError(f"bf16 mega eval launches {launches}, the fp32 mega "
                             f"eval's {fp32_mega_launches}")
    rel = {}
    for k, v in metrics.items():
        rel[k] = abs(v - bf16_metrics[k]) / max(abs(bf16_metrics[k]), 1e-30)
        unheld = k.startswith("test_pde_loss") and not k.endswith("_gt")
        if not math.isfinite(v) or (not unheld and rel[k] > TOL_BF16_METRICS):
            raise AssertionError(f"bf16 mega {k}: {v} vs bf16 per-conv {bf16_metrics[k]}")
    ptask = build_task(hp, device)
    pstate = ptask.init_state(None, stats, params=params)
    walls, pwalls = [wall], []
    for _ in range(MEGA_RUNS):  # in turns: per-conv, mega, per-conv, mega
        pwalls.append(run_eval(ptask, pstate, batch, mask, device)[2])
        walls.append(run_eval(task, state, batch, mask, device)[2])
    n = b * hp["sampler"]["n_samples"]
    wall, pwall = float(np.median(walls[1:])), float(np.median(pwalls))
    emit({"phase": "bf16_mega_eval", "mask": "u", "batch": b,
          "nvidia_smi": nvidia_smi_line(), "unet_forwards": calls, "metrics": metrics,
          "per_conv_metrics": bf16_metrics, "metrics_rel_diff": rel,
          "metrics_tol": TOL_BF16_METRICS, "known_channel_max_err": known_err,
          "launches": {k: v for k, v in launches.items() if v},
          "launches_per_forward": {k: launches[k] / calls for k in MEGA_LAUNCHES},
          "wall_s": walls, "per_conv_wall_s": pwalls,
          "samples_per_s": n / wall, "per_conv_samples_per_s": n / pwall})
    return launches


def phase_bf16_mega_cond(device, b: int) -> dict:
    """Phase 15.8: the conditional ADM tasks in bf16 with mega=True at full
    width and depth against their bf16 plain path (the same weights, batch
    and noise): CondEdmTask (adm_edm_cond_h, phase 11's inputs) and
    CondDdimTask on the ADM U-Net (adm_cond_h, phase 13's inputs), one eval
    each; metrics within TOL_BF16_METRICS (test_pde_loss reported), the
    sample's mean gap to the plain path's under its gap to the fp32 mega
    eval's, the launches per forward of the fp32 mega evals (MEGA_LAUNCHES,
    as phases 11 and 13 assert them), samples/s of both paths in turns.
    Returns CondEdmTask's launches."""
    import torch

    from m_cedm_tpu_torch import kernels
    from m_cedm_tpu_torch.tasks import build_task

    cases = (("adm_edm_cond_h", COND_EDM_HPARAMS, COND_EDM_TARGET, SEED + 11, SEED + 12,
              SEED + 13),
             ("adm_cond_h", ADM_COND_HPARAMS, COND_DDIM_TARGET, SEED + 72, SEED + 62,
              SEED + 73))
    out = {}
    for name, hp32, target, data_seed, param_seed, gen_seed in cases:
        hp = bf16_hparams(hp32)
        batch, stats = baseline_data(device, hp, b, data_seed)
        paths = {"mega": (hp, kernels.DEVICE_OPS, True),
                 "plain": (hp, kernels.PLAIN_OPS, False),
                 "fp32_mega": (hp32, kernels.DEVICE_OPS, True)}
        tasks = {k: build_task(h, device, target=target, ops=ops, mega=m)
                 for k, (h, ops, m) in paths.items()}
        params = seeded_params(tasks["mega"].model, param_seed)
        states = {k: t.init_state(None, stats, params=params) for k, t in tasks.items()}

        def run(k):
            task = tasks[k]
            if target == COND_DDIM_TARGET:
                task.set_test_sampler_params(hp["sampler"])
            gen = torch.Generator(device=device).manual_seed(gen_seed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics, pred = task.eval_step(states[k], batch, gen, split="test")
            torch.cuda.synchronize()
            return ({kk: float(v) for kk, v in metrics.items()}, pred,
                    time.perf_counter() - t0)

        tasks["mega"].model.calls = 0
        kernels.reset_launches()
        metrics, pred, wall = run("mega")
        launches, calls = kernels.launches(), tasks["mega"].model.calls
        r = hp["model"]["resolution"]
        if tuple(pred.shape) != (b, r, r, 1) or not torch.isfinite(pred).all():
            raise AssertionError(f"{name} bf16 mega sample {tuple(pred.shape)} not finite")
        check_mega_launches(launches, calls, f"{name} bf16 mega eval ({calls} forwards)")
        fp32_metrics, fp32_pred, _ = run("fp32_mega")
        walls, pwalls = [wall], []
        for _ in range(MEGA_RUNS):  # in turns: plain, mega, plain, mega
            pmetrics, ppred, pwall = run("plain")
            pwalls.append(pwall)
            walls.append(run("mega")[2])
        rel = {}
        for k, v in metrics.items():
            rel[k] = abs(v - pmetrics[k]) / max(abs(pmetrics[k]), 1e-30)
            held = not (k.startswith("test_pde_loss") and not k.endswith("_gt"))
            # a correlation near zero (random weights) is held absolute
            err = abs(v - pmetrics[k]) if "corr" in k else rel[k]
            if not math.isfinite(v) or (held and err > TOL_BF16_METRICS):
                raise AssertionError(f"{name} bf16 mega {k}: {v} vs bf16 plain {pmetrics[k]}")
        gaps = {"mega_vs_plain": float((pred - ppred).abs().mean()),
                "bf16_vs_fp32_mega": float((pred - fp32_pred).abs().mean())}
        if not gaps["mega_vs_plain"] < gaps["bf16_vs_fp32_mega"]:
            raise AssertionError(f"{name} bf16 mega sample gaps {gaps}")
        n = b * hp["sampler"].get("n_samples", 1)
        wall, pwall = float(np.median(walls[1:])), float(np.median(pwalls))
        emit({"phase": "bf16_mega_cond", "config": name, "batch": b,
              "unet_forwards": calls, "metrics": metrics, "plain_metrics": pmetrics,
              "fp32_mega_metrics": fp32_metrics, "metrics_rel_diff": rel,
              "metrics_tol": TOL_BF16_METRICS,
              "unheld": [k for k in metrics if k.startswith("test_pde_loss")
                         and not k.endswith("_gt")],
              "sample_mean_abs_gaps": gaps,
              "launches": {k: v for k, v in launches.items() if v},
              "wall_s": walls, "plain_wall_s": pwalls,
              "samples_per_s": n / wall, "plain_samples_per_s": n / pwall})
        out[name] = launches
    return out["adm_edm_cond_h"]


def phase_bf16(device, hparams, params, b: int, fp32_launches: dict, run2_dir: str,
               eval_dir: str, fp32_mega_launches: dict):
    """Phase 15: bf16 serving of the flagship on the card (parts 1-8; the
    reduced-precision-reduction flag is on from part 2 to the end). Returns
    the per-kernel summaries, the bf16 eval's launches and the bf16 mega
    evals' (the flagship's, CondEdmTask's)."""
    import torch

    m = hparams["model"]
    results = phase_bf16_kernels(device, b, m["resolution"], m["ch"])
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    try:
        phase_bf16_forward(device, hparams, params, b)
        ev = phase_bf16_eval(device, hparams, params, b, fp32_launches)
        phase_bf16_matmul_flag(device)
        phase_bf16_cli(device, run2_dir, eval_dir, ev["per_forward"])
        results.update(phase_bf16_mega_kernel(device, b, m["resolution"], m["ch"]))
        mega = phase_bf16_mega_eval(device, hparams, params, b, fp32_mega_launches,
                                    ev["metrics"])
        cond = phase_bf16_mega_cond(device, b)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    return results, ev["launches"], {"eval": mega, "cond_edm": cond}


# Phase 16: bf16 training. The fp32 outputs of a bf16 backward kernel (dW,
# dbias, dgamma, dbeta) sum exact bf16 products in another order than the
# plain version, and a recomputed activation that rounds to bf16 may flip
# an ulp where the two sides' fp32 values differ in the last bit
TOL_BF16_BWD_F32 = 1e-3
# the bf16 train step, kernel path against the bf16 plain path: the two
# round the backward at different points (the plain path is autograd of the
# plain forward), within a few bf16 roundings of each gradient
TOL_BF16_TRAIN = 1e-2
# the kernel path's gradient gap to the fp32 step against the plain path's
BF16_GAP_RATIO = 1.5
# K1's bf16 backward and conv_in's bf16 wgrad at ragged shapes beside the
# train step's (phase 16.1): K1 (B, N, C, groups, eps) at a sample over 64
# clusters, 80 samples of one block, C 2048 and 8; the wgrad (B, H, W, C,
# O) with g by TMA (O 24, 64) and by cp.async pairs (O 20), C 8, 3 and 4
K1_BWD_BF16_RAGGED = ((1, 100003, 128, 32, 1e-6), (80, 333, 128, 32, 1e-6),
                      (2, 4099, 2048, 32, 1e-6), (1, 333, 8, 8, 1e-5))
WGRAD_BF16_RAGGED = ((3, 13, 37, 8, 24), (2, 29, 21, 3, 64), (16, 127, 129, 4, 64),
                     (2, 19, 40, 2, 20))
BF16_BWD_KERNELS = {f"{name} bf16": name for name in (
    "K1 gn_silu_bwd", "K2 gn_silu_conv_bwd", "K2 narrow_conv_bwd",
    "K3 gn_silu_up_conv_bwd", "K4 attention_bwd", "K2 gn_dx")}
# the bf16 backward's dx pass has no fp32 instance: its source, and the
# XLA pass it stands for (_dx_from_da, which phase A's kernel feeds; no
# Pallas kernel of its own)
BF16_ONLY_INFO = {"K2 gn_dx": ("m_cedm_tpu_torch/csrc/fused_norm_conv_bwd.cu",
                               "m_cedm_tpu/pallas/fused_norm_conv.py:1425")}
# the bf16 train step's device busy before the bf16 K4's wgmma redesign
# (PERF.md section 5: the profiled step of phase 16.2 on the parent commit
# of that redesign, one H100 80GB HBM3 at 700.00 W)
PARENT_BF16_STEP_BUSY_MS = 13.27


def bf16_grads_error(got, want, name: str) -> dict:
    """Each output of a bf16 backward against its plain version: bf16 ones by
    bf16_error, fp32 ones to TOL_BF16_BWD_F32 of their scale; None where the
    kernel computes no such output."""
    import torch

    errs = []
    for i, (a, w) in enumerate(zip(got, want)):
        if a is None:
            continue
        if a.dtype != w.dtype:
            raise AssertionError(f"{name} output {i}: dtype {a.dtype}, plain {w.dtype}")
        if a.dtype == torch.bfloat16:
            errs.append(dict(bf16_error(a, w, f"{name} output {i}"), output=i))
        else:
            e = compare(a, w, 1.0, f"{name} output {i}")
            scale = float(w.double().abs().max())
            rel = e["max_abs_err"] / max(scale, 1e-30)
            if rel > TOL_BF16_BWD_F32:
                raise AssertionError(f"{name} output {i}: fp32 error {rel:.3e} of scale")
            errs.append({"output": i, "max_abs_err": e["max_abs_err"], "max_rel_err": rel,
                         "tol": TOL_BF16_BWD_F32})
    return {"outputs": errs,
            "max_abs_err": max(e["max_abs_err"] for e in errs),
            "max_rel_err": max(e["max_rel_err"] for e in errs)}


def phase_bf16_backward(device, b: int, res: int, ch: int) -> dict:
    """Phase 16.1: every bf16 backward kernel, its wrapper called directly,
    against its bf16 plain version at the flagship train step's shapes, with
    times, bounds and the library's autograd backward; returns per-kernel
    summaries keyed by BF16_BWD_KERNELS' names."""
    import torch
    import torch.nn.functional as F

    from m_cedm_tpu_torch.kernels import fused_attention as fa
    from m_cedm_tpu_torch.kernels import fused_norm as fn
    from m_cedm_tpu_torch.kernels import fused_norm_conv as fnc
    from m_cedm_tpu_torch.models.layers import adm_groups

    bf = torch.bfloat16
    g = torch.Generator(device=device).manual_seed(SEED + 70)

    def rnd(*shape, scale=1.0, shift=0.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=device) * scale + shift).to(dtype)

    def fold(c):
        return (rnd(b, c, scale=0.3, shift=1.0, dtype=torch.float32),
                rnd(b, c, scale=0.3, dtype=torch.float32))

    results = {}

    def f32(*ts):
        return [None if t is None else t.float() for t in ts]

    def check(kernel, mode, k_fn, p_fn, work, lib_fn=None, f32_fn=None, pieces=None,
              extra=None, repeat=False):
        """f32_fn: the fp32 kernels on the same inputs upcast, whose device
        time is recorded beside the bf16 kernels' (`fp32_device_ms`);
        pieces: the call's kernels apart ({name: call}), each one's device
        time recorded (`split_device_ms`); extra: fields recorded as they
        are (a plan); repeat: two calls must give the same bits."""
        got = k_fn()
        err = bf16_grads_error(got, p_fn(), f"{kernel} {mode}")
        if repeat:
            again = k_fn()
            if not all(a is b_ or torch.equal(a, b_) for a, b_ in zip(got, again)):
                raise AssertionError(f"{kernel} {mode}: two calls gave different bits")
        lim = bound(*work)
        rec = {"phase": "bf16_backward", "kernel": kernel, "mode": mode, **err,
               "ms": cuda_ms(k_fn), "device_ms": device_ms(k_fn, lim),
               "plain_ms": cuda_ms(p_fn), **lim, "library_ms": None, **(extra or {}),
               **({"same_bits_on_repeat": True} if repeat else {})}
        if pieces:
            unbounded = {"bound_ms": 0.0, "bytes": 0}
            rec["split_device_ms"] = {k: device_ms(f, unbounded) for k, f in pieces.items()}
        if f32_fn is not None:
            rec["fp32_device_ms"] = device_ms(f32_fn, lim)
        if lib_fn is not None:
            rec["library_ms"] = cuda_ms(lib_fn)
        emit(rec)
        prev = results.get(kernel)
        if prev is None:
            results[kernel] = dict(rec, modes=[])
        else:
            for k in ("max_abs_err", "max_rel_err"):
                prev[k] = max(prev[k], rec[k])
        results[kernel]["modes"].append(
            {k: rec[k] for k in ("mode", "ms", "device_ms", "fp32_device_ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms", "max_rel_err",
                                 "split_device_ms", "plan", "same_bits_on_repeat")
             if k in rec})
        return rec

    def conv_bwd_lib(x, w):
        """bf16 conv2d's autograd backward (cuDNN) of the conv alone on x's
        shape: the library's time for the same products."""
        xs = x.detach().clone().requires_grad_()
        ws = w.detach().clone().requires_grad_()
        out = F.conv2d(xs.permute(0, 3, 1, 2), ws.permute(3, 2, 0, 1), padding=1)
        cot = torch.randn(out.shape, generator=g, device=device).to(bf)
        return lambda: torch.autograd.grad(out, (xs, ws), cot, retain_graph=True)

    # K1 backward: the down blocks' norm0 at res and res/2, the out head's;
    # then ragged cases (K1_BWD_BF16_RAGGED), each with its plan (the
    # clusters a sample, the rows kept in shared memory between the passes)
    gr = adm_groups(ch)
    for bb, n, c, groups, eps in [(b, r * r, ch, gr, 1e-5) for r in (res, res // 2)] + list(
            K1_BWD_BF16_RAGGED):
        x = rnd(bb, n, c, scale=0.8, shift=0.2)
        gy = rnd(bb, n, c)
        gamma = rnd(bb, c, scale=0.3, shift=1.0, dtype=torch.float32)
        beta = rnd(bb, c, scale=0.3, dtype=torch.float32)
        stats = fn.channel_stats_plain(x)
        main_path = (bb, c, groups) == (b, ch, gr) and n in (res * res, res * res // 4)
        mode = (f"chained stats, res {math.isqrt(n)}" if main_path else
                f"ragged: B {bb}, N {n}, C {c}, {groups} groups, eps {eps:g}")
        x32, gy32 = f32(x, gy) if main_path else (None, None)
        check("K1 gn_silu_bwd bf16", mode,
              lambda x=x, gy=gy, gm=gamma, bt=beta, st=stats, gg=groups, e=eps: fn.gn_silu_bwd(
                  gy, x, gm, bt, st, gg, e),
              lambda x=x, gy=gy, gm=gamma, bt=beta, st=stats, gg=groups, e=eps:
                  fn.gn_silu_bwd_bf16_plain(gy, x, gm, bt, gg, e, stats=st),
              (nbytes(x, gy, x, gamma, beta, *stats, gamma, beta), 20.0 * x.numel()),
              f32_fn=(lambda x=x32, gy=gy32, gm=gamma, bt=beta, st=stats: fn.gn_silu_bwd(
                  gy, x, gm, bt, st, gr)) if main_path else None,
              extra={"plan": fn.bwd_bf16_plan(bb, n, c, groups, device)}, repeat=True)
        del x, gy, x32, gy32

    def conv_w(ci, co):
        return rnd(3, 3, ci, co, scale=1.0 / math.sqrt(9 * ci))

    def wgrad_library(xin, gy):
        """bf16 aten.convolution_backward of the weight and bias gradients
        alone (no input gradient) on the NHWC operands' NCHW views"""
        o, c = gy.shape[-1], xin.shape[-1]
        wz = torch.zeros((o, c, 3, 3), device=device, dtype=bf)
        xn, gn = xin.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)
        return lambda: torch.ops.aten.convolution_backward(
            gn, xn, wz, [o], [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [False, True, True])

    def narrow_wgrad_case(xin, gy, name):
        """conv_in's bf16 wgrad (linear, with dbias) called directly"""
        bb, hh, ww, c = xin.shape
        o = gy.shape[-1]

        def kern():
            return fnc._wgrad(xin, gy, None, None, None, 0, 1e-5, 9, False, True)

        got, again = kern(), kern()
        if not all(torch.equal(a, a2) for a, a2 in zip(got, again)):
            raise AssertionError(f"conv_in wgrad bf16 {name}: two calls gave different bits")
        err = bf16_grads_error(got, (fnc.conv3x3_wgrad_plain(xin.float(), gy.float()),
                                     gy.float().sum(dim=(0, 1, 2))), f"conv_in wgrad bf16 {name}")
        lim = bound(nbytes(xin, gy) + 4 * (9 * c * o + o), 2.0 * 9 * c * o * bb * hh * ww, 0,
                    PEAK_BF16)
        lib = wgrad_library(xin, gy)
        rec = {"device_ms": device_ms(kern, lim), "library_device_ms": device_ms(lib, lim),
               "bound_ms": lim["bound_ms"], "bound_by": lim["bound_by"],
               "max_rel_err": err["max_rel_err"], "same_bits_on_repeat": True,
               "plan": dict(zip(("tile_rows", "resident", "blocks", "smem", "rows"),
                                fnc._bf16_bwd_plan(1, False, bb, hh, ww, c, o, 9, device)))}
        emit({"phase": "bf16_backward", "kernel": "conv_in wgrad bf16", "case": name, **rec})
        return rec

    def bwd_pieces(gy, x, gamma, beta, w, stats, groups, need_da, kw, up=False,
                   torch_dx=False):
        """The K2 / K3 bf16 backward's kernels apart: wgrad (and the
        projection's one-tap wgrad), dgrad, the dx pass, each with its
        reduce; with torch_dx also the parent's dx pass, dx_from_da's
        PyTorch passes on the same da."""
        act = gamma is not None
        pieces = {"wgrad": lambda: fnc._wgrad(x, gy, gamma, beta, stats, groups, 1e-5, 9,
                                              up, True)}
        if kw.get("skip_w") is not None:
            res_ = kw["residual"]
            pieces["wgrad, one tap"] = lambda: fnc._wgrad(res_, gy, None, None, None, 0,
                                                          1e-5, 1, False, False)
        if need_da:
            mode = (fnc._DGRAD_UP_FOLD if up else
                    fnc._DGRAD_ACT if act else fnc._DGRAD_LINEAR)
            da = torch.empty(x.shape, device=device,
                             dtype=torch.float32 if up else bf)
            pieces["dgrad"] = lambda: fnc._dgrad(gy, w, x if act else None, gamma, beta,
                                                 stats, groups, 1e-5, mode, da)
            if act:
                dst = pieces["dgrad"]()
                pieces["dx pass"] = lambda: fnc.gn_dx(x, da, gamma, dst, stats, groups)
                if torch_dx:
                    n = x.shape[1] * x.shape[2]
                    mean, rstd = fn.group_mean_rstd_from_sums(*stats, n, groups, 1e-5)
                    pieces["dx pass, PyTorch (parent style)"] = lambda: fn.dx_from_da(
                        x, da, gamma, dst[0], dst[1], mean, rstd, groups).to(bf)
        return pieces

    def k2(mode, x, gamma, beta, w, need_da=True, **kw):
        act = gamma is not None
        groups = adm_groups(x.shape[-1]) if act else 0
        stats = fn.channel_stats_plain(x.reshape(b, -1, x.shape[-1])) if act else None
        b_, h_, w_, c_ = x.shape
        o = w.shape[-1]
        gy = rnd(b_, h_, w_, o)

        def kern():
            return fnc.gn_silu_conv_bwd(gy, x, gamma, beta, w, stats, groups, 1e-5,
                                        need_da=need_da, **kw)

        def plain():
            out = fnc.gn_silu_conv_bwd_plain(gy, x, gamma, beta, w, groups, 1e-5,
                                             stats=stats, **kw)
            return out if need_da else (None,) + out[1:]

        cr = kw["residual"].shape[-1] if kw.get("skip_w") is not None else 0
        flops = conv_flops(b_, h_, w_, c_, o) * (2 if need_da else 1) + 4.0 * b_ * h_ * w_ * cr * o
        # the proj mode alone reads the residual; identity's dres is gy itself
        outs = [t for t in plain() if t is not None and t is not gy]
        work = (nbytes(gy, x, gamma, beta, w, *(stats or ()),
                       kw.get("residual") if cr else None, kw.get("skip_w"), *outs),
                flops, 0, PEAK_BF16)
        x32, gy32, w32 = f32(x, gy, w)
        kw32 = {k: v.float() if torch.is_tensor(v) else v for k, v in kw.items()}

        def kern32():
            return fnc.gn_silu_conv_bwd(gy32, x32, gamma, beta, w32, stats, groups, 1e-5,
                                        need_da=need_da, **kw32)

        return check("K2 gn_silu_conv_bwd bf16", mode, kern, plain, work,
                     lib_fn=conv_bwd_lib(x, w), f32_fn=kern32,
                     pieces=bwd_pieces(gy, x, gamma, beta, w, stats, groups, need_da, kw,
                                       torch_dx=mode.startswith("identity (")))

    h = rnd(b, res, res, ch, scale=0.8, shift=0.2)
    gamma, beta = fold(ch)
    w = conv_w(ch, ch)
    k2("identity (block tail), chained stats", h, gamma, beta, w,
       residual=rnd(b, res, res, ch))
    k2("identity_up", h, gamma, beta, w, residual=rnd(b, res // 2, res // 2, ch),
       res_up=True)
    xc = rnd(b, res, res, 2 * ch, scale=0.8, shift=0.2)
    k2("proj from 128-channel concat (conv1 + tail)", h, gamma, beta, w, residual=xc,
       skip_w=rnd(2 * ch, ch, scale=1.0 / math.sqrt(2 * ch)))
    gc, bc = fold(2 * ch)
    k2("128-channel input (decoder conv0)", xc, gc, bc, conv_w(2 * ch, ch))
    k2("act=False (conv_in, no input gradient)", rnd(b, res, res, 4), None, None,
       conv_w(4, ch), need_da=False)
    # conv_in's wgrad alone (wgrad_narrow_bf16_kernel and its reduce), called
    # directly at the flagship's (C 4) and adm_edm_cond_h's (C 2) shapes and
    # ragged ones: against its plain version, bits on a repeat, its plan,
    # beside bf16 convolution_backward of the weight and bias gradients alone
    # on the same inputs (the same function; output_mask [False, True, True])
    wgrad_cases = {}
    for bb, hh, ww, c, o in ((b, res, res, 4, ch), (b, res, res, 2, ch)) + WGRAD_BF16_RAGGED:
        xin, gy = rnd(bb, hh, ww, c), rnd(bb, hh, ww, o)
        name = f"B {bb}, {hh}x{ww}, C {c} -> O {o}"
        wgrad_cases[name] = narrow_wgrad_case(xin, gy, name)
    results["K2 gn_silu_conv_bwd bf16"]["conv_in_wgrad"] = wgrad_cases
    k2("act=False (down-block conv0 at res/2)", rnd(b, res // 2, res // 2, ch, scale=0.8),
       None, None, w)

    # the narrow backward: the out conv, C 64 -> O 2
    w_out = conv_w(ch, 2)
    gy = rnd(b, res, res, 2)
    gy32, h32, wo32 = f32(gy, h, w_out)
    # (the dgrad on narrow_c_bf16_kernel with mirrored taps: the whole call
    # less the wgrad alone)
    check("K2 narrow_conv_bwd bf16", "out conv, C 64 -> O 2",
          lambda: fnc.narrow_conv_bwd(gy, h, w_out),
          lambda: fnc.narrow_conv_bwd_plain(gy, h, w_out),
          (nbytes(gy, h, w_out, h, w_out) + 4 * 2, 2 * conv_flops(b, res, res, ch, 2), 0,
           PEAK_BF16), lib_fn=conv_bwd_lib(h, w_out),
          f32_fn=lambda: fnc.narrow_conv_bwd(gy32, h32, wo32),
          pieces={"dgrad + wgrad": lambda: fnc.narrow_conv_bwd(gy, h, w_out),
                  "wgrad alone": lambda: fnc.narrow_conv_bwd(gy, h, w_out, need_dx=False)})
    # the out conv's wgrad beside the same function's library call
    results["K2 narrow_conv_bwd bf16"]["wgrad_library_device_ms"] = device_ms(
        wgrad_library(h, gy), {"bound_ms": 0.0, "bytes": 0})

    # K3 backward: the decoder's up-block conv0, res/2 -> res
    xl = rnd(b, res // 2, res // 2, ch, scale=0.8, shift=0.2)
    xl_stats = fn.channel_stats_plain(xl.reshape(b, -1, ch))
    gy = rnd(b, res, res, ch)
    gy32, xl32, w32 = f32(gy, xl, w)
    check("K3 gn_silu_up_conv_bwd bf16", "up block conv0, chained stats",
          lambda: fnc.gn_silu_up_conv_bwd(gy, xl, gamma, beta, w, xl_stats, gr),
          lambda: fnc.gn_silu_up_conv_bwd_plain(gy, xl, gamma, beta, w, gr, stats=xl_stats),
          (nbytes(gy, xl, gamma, beta, w, *xl_stats, xl, w) + 4 * (4 * b * ch + ch),
           2 * conv_flops(b, res, res, ch, ch), 0, PEAK_BF16),
          lib_fn=conv_bwd_lib(rnd(b, res, res, ch), w),
          f32_fn=lambda: fnc.gn_silu_up_conv_bwd(gy32, xl32, gamma, beta, w32, xl_stats, gr),
          pieces=bwd_pieces(gy, xl, gamma, beta, w, xl_stats, gr, True, {}, up=True))

    # the dx pass alone: K2's bf16 da at the res-128 tail, K3's fp32 da at
    # its low resolution; bound by bytes (x and da read, dx written)
    for mode, xs, da_dt in (("res-128 tail, bf16 da", h, bf),
                            ("K3's low-res tail, fp32 da", xl, torch.float32)):
        da = rnd(*xs.shape, scale=0.1, dtype=da_dt)
        dst = rnd(2, b, ch, scale=30.0, dtype=torch.float32)
        st = fn.channel_stats_plain(xs.reshape(b, -1, ch))
        check("K2 gn_dx bf16", mode,
              lambda xs=xs, da=da, dst=dst, st=st: (fnc.gn_dx(xs, da, gamma, dst, st, gr),),
              lambda xs=xs, da=da, dst=dst, st=st: (
                  fnc.gn_dx_plain(xs, da, gamma, dst, st, gr),),
              (nbytes(xs, da, gamma, dst, *st, xs), 8.0 * xs.numel()))

    # K4 backward at the 32x32 sites: the bf16 forward's o32 (the output
    # before its rounding) feeds delta; held to the fp32 plain forward first.
    # The bound is the least work that keeps fp32 accuracy (k4_bf16_bound):
    # S and dP one bf16 product each, dv, dq and dk three each
    L = (res // 4) ** 2
    q, k, v, gy = (rnd(b, L, 64) for _ in range(4))
    lse = torch.empty(b, L, device=device)
    o32 = torch.empty(b, L, 64, device=device)
    with torch.no_grad():
        fa.attention_fwd(q, k, v, lse, o32)
        o32_err = compare(o32, fa.attention_plain(q.float(), k.float(), v.float()),
                          TOL_KERNEL, "K4 bf16 forward's o32")
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    sd = F.scaled_dot_product_attention(qs[:, None], ks[:, None], vs[:, None])[:, 0]
    prod = 2.0 * b * L * L * 64
    work, tf32_work = k4_bf16_bound(nbytes(q, k, v, gy, o32, lse, q, k, v), prod, 2, 3)
    q32, k32, v32, gy32 = f32(q, k, v, gy)
    lse32 = torch.empty(b, L, device=device)
    with torch.no_grad():
        o_32 = fa.attention_fwd(q32, k32, v32, lse32)
    rec = check("K4 attention_bwd bf16", "(N, L, D)",
                lambda: fa.attention_bwd(gy, q, k, v, o32, lse),
                lambda: fa.attention_bwd_plain(gy, q, k, v),
                work, lib_fn=lambda: torch.autograd.grad(sd, (qs, ks, vs), gy,
                                                         retain_graph=True),
                f32_fn=lambda: fa.attention_bwd(gy32, q32, k32, v32, o_32, lse32))
    rep = [fa.attention_bwd(gy, q, k, v, o32, lse) for _ in range(2)]
    if not all(torch.equal(a, c) for a, c in zip(*rep)):
        raise AssertionError("K4 attention_bwd bf16: two calls gave different bits")
    results["K4 attention_bwd bf16"].update(
        o32_max_rel_err=o32_err["max_rel_err"], bound_tf32_ms=bound(*tf32_work)["bound_ms"],
        sass=k4_bf16_sass("attention_bwd_d"))
    emit({"phase": "bf16_backward", "kernel": "K4 attention_bwd bf16",
          "o32_vs_fp32_plain": o32_err, "kernel_ms": rec["ms"],
          **{k: results["K4 attention_bwd bf16"][k] for k in ("bound_tf32_ms", "sass")}})
    return results


def device_ms(fn, work: dict, n: int = 10) -> float:
    """The card's time of one fn() (kernels/_timing.py: n calls bracketed by
    CUDA events behind a spin kernel, so it reads the card, not the host).
    Raises where the time is under `work`'s bound (bound()) while the call's
    bytes exceed the L2, which no data the call reads can then be served
    from."""
    from m_cedm_tpu_torch.kernels._timing import device_ms as timed

    ms = timed(fn, n)
    if ms < work["bound_ms"] and work["bytes"] > L2_BYTES:
        raise AssertionError(f"device_ms {ms:.4f} under the bound {work['bound_ms']:.4f} "
                             f"of a call that moves {work['bytes']} bytes")
    return ms


def grads_gap(grads, ref) -> float:
    """The mean over parameters of mean |g - ref| / max |ref| (the attention
    key biases, whose exact gradient is zero, left out)."""
    keys = [k for k in ref if not k.endswith(".k.bias")]
    return float(np.mean([float((grads[k].double() - ref[k].double()).abs().mean()
                                / ref[k].double().abs().max()) for k in keys]))


def phase_bf16_train(device, hparams, params, b: int, fp32_launches: dict) -> dict:
    """Phase 16.2: McedmTask.train_step with model.dtype bfloat16 at full
    width and depth, kernel path against the bf16 plain path over
    TRAIN_STEPS steps from phase 5's state; the gradient gaps to the fp32
    step; launches per step against phase 5's; ms per step of the bf16 and
    the fp32 kernel path in turns; one profiled bf16 step. Returns the
    launches of the kernel path's steps."""
    import torch

    from m_cedm_tpu_torch import kernels
    from m_cedm_tpu_torch.tasks import build_task

    hp16 = bf16_hparams(hparams)
    r = hparams["model"]["resolution"]
    lr = hparams["optimization"]["lr"]
    rs = np.random.RandomState(SEED + 4)  # phase 5's batch
    h, tg, xg, u = synthetic_swe_batch(rs, b, r)
    stats = {"input_mean": h.mean(), "input_std": h.std(),
             "target_mean": u.mean(), "target_std": u.std()}
    batch = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                  for a in (h, tg, xg, u))
    ktask = build_task(hp16, device)
    ptask = build_task(hp16, device, ops=kernels.PLAIN_OPS)
    ftask = build_task(hparams, device)
    kstate = ktask.init_state(None, stats, params=params)
    pstate = ptask.init_state(None, stats, params=params)
    fstate = ftask.init_state(None, stats, params=params)

    def grads_of(task, state):
        gen = torch.Generator(device=device).manual_seed(SEED + 10)  # step 0's draws
        return task.loss_and_grads(state, batch, gen)[1]

    g32 = grads_of(ftask, fstate)
    gap_k = grads_gap(grads_of(ktask, kstate), g32)
    gap_p = grads_gap(grads_of(ptask, pstate), g32)
    if not gap_k <= BF16_GAP_RATIO * gap_p:
        raise AssertionError(f"bf16 kernel path's gradient gap to fp32 {gap_k:.3e}, "
                             f"plain path's {gap_p:.3e}")

    kernels.reset_launches()
    kfinal, kmetrics, _ = train_steps(ktask, kstate, batch, device, 0, TRAIN_STEPS)
    launches = kernels.launches()
    pfinal, pmetrics, _ = train_steps(ptask, pstate, batch, device, 0, TRAIN_STEPS)
    for step, (km, pm) in enumerate(zip(kmetrics, pmetrics)):
        for key in ("train_loss", "grad_norm"):
            if (not math.isfinite(km[key])
                    or abs(km[key] - pm[key]) > TOL_BF16_TRAIN * abs(pm[key])):
                raise AssertionError(f"bf16 step {step} {key}: kernel {km[key]} vs "
                                     f"plain {pm[key]}")

    def max_diff(a, b_):
        return max(float((a[k] - b_[k]).abs().max()) for k in a)

    tol_params = 2 * lr * TRAIN_STEPS
    diffs = {"params": max_diff(kfinal.params, pfinal.params),
             "ema_params": max_diff(kfinal.ema_params, pfinal.ema_params)}
    if not (diffs["params"] <= tol_params and diffs["ema_params"] <= tol_params):
        raise AssertionError(f"bf16 params after {TRAIN_STEPS} steps differ: {diffs}")
    fp32_state = all(t.dtype == torch.float32 for tree in (
        kfinal.params, kfinal.ema_params, kfinal.opt_state["mu"], kfinal.opt_state["nu"])
        for t in tree.values())
    if not fp32_state:
        raise AssertionError("the bf16 step's master params, Adam state or EMA left fp32")
    # the bf16 steps launch what phase 5's fp32 steps launch
    names = list(FLAGSHIP_KERNELS)
    got = {k: launches[k] for k in names}
    want = {k: fp32_launches[k] for k in names}
    if got != want:
        raise AssertionError(f"bf16 train steps launched {got}, the fp32 steps {want}")
    missing = [k for k in BF16_BWD_KERNELS.values() if launches[k] == 0]
    if missing:
        raise AssertionError(f"bf16 backward kernels not launched: {missing}")

    n = TRAIN_WARMUP + TRAIN_TIMED  # in turns: fp32, bf16, bf16, fp32
    fstate_t, kstate_t = fstate, kfinal
    walls = {"fp32": [], "bf16": []}
    for name in ("fp32", "bf16", "bf16", "fp32"):
        task, st = (ftask, fstate_t) if name == "fp32" else (ktask, kstate_t)
        st, _, w = train_steps(task, st, batch, device, TRAIN_STEPS, n)
        walls[name].append(float(np.median(w[TRAIN_WARMUP:])) * 1e3)
        if name == "fp32":
            fstate_t = st
        else:
            kstate_t = st
    prof = profile_step(ktask, kstate_t, batch, device, min(walls["bf16"]) / 1e3)
    rec = {"phase": "bf16_train", "batch": b, "steps": TRAIN_STEPS,
           "nvidia_smi": nvidia_smi_line(),
           "train_loss": [m["train_loss"] for m in kmetrics],
           "plain_train_loss": [m["train_loss"] for m in pmetrics],
           "grad_norm": [m["grad_norm"] for m in kmetrics],
           "plain_grad_norm": [m["grad_norm"] for m in pmetrics],
           "tol": TOL_BF16_TRAIN, "max_abs_diff": diffs, "tol_params": tol_params,
           "grad_gap_to_fp32": gap_k, "plain_grad_gap_to_fp32": gap_p,
           "gap_ratio": gap_k / gap_p, "gap_ratio_tol": BF16_GAP_RATIO,
           "fp32_state": fp32_state, "parent_device_busy_ms": PARENT_BF16_STEP_BUSY_MS,
           "launches_per_step": {k: launches[k] / TRAIN_STEPS for k in names},
           "ms_per_step": walls["bf16"], "fp32_ms_per_step": walls["fp32"],
           "order": ["fp32", "bf16", "bf16", "fp32"], "profile": prof}
    emit(rec)
    return launches


def phase_bf16_train_cli(device, per_step: dict) -> dict:
    """Phase 16.3: config_adm_edm_mcedm_res32.yaml with trainer.precision=bf16
    through m_cedm_tpu_torch.run (fit, then a resume to epoch 2) and
    m_cedm_tpu_torch.eval_model on the resumed run, on phase 12's seeded
    data: phase 12's key set, every metric finite, the resume trains epoch 1
    only, the checkpoint's params, Adam state and EMA fp32, each train
    step's launches equal to part 2's per step. Removes its directory."""
    import importlib.util
    import os
    import shutil

    import torch

    from m_cedm_tpu_torch import eval_model, run
    from m_cedm_tpu_torch.data import datamodule as dm_module
    from m_cedm_tpu_torch.data.h5_io import write_store

    have = {m: importlib.util.find_spec(m) is not None for m in ("h5py", "matplotlib")}
    res = FLAGSHIP_HPARAMS["model"]["resolution"]
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "cli_bf16_train")
    shutil.rmtree(root, ignore_errors=True)
    sub = os.path.join(root, "1D_swp_128_per")
    os.makedirs(sub)
    stores = cli_stores(res)
    paths = {split: os.path.join(sub, f"1D_swp_128_per_{split}.h5") for split in stores}
    saved_read, saved_wandb = dm_module.read_store, sys.modules.get("wandb")
    if have["h5py"]:
        for split, st in stores.items():
            write_store(paths[split], st.inputs, st.targets, st.x, st.t)
    else:
        by_path = {paths[split]: st for split, st in stores.items()}
        dm_module.read_store = by_path.__getitem__
    sys.modules["wandb"] = None
    job = ["system=swe_per", f"dataroot={root}", "trainer.precision=bf16"]
    if not have["matplotlib"]:
        job.append("callbacks=callbacks_save_model")
    base = ["--config-name", CLI_CONFIG] + job
    run_dir, run2_dir, eval_dir = (os.path.join(root, d) for d in ("run", "run2", "eval"))
    secs = {}
    try:
        with CliProbe() as probe:
            for name, fn, extra in (
                    ("fit", run.main, ["trainer.max_epochs=1", f"hydra.run.dir={run_dir}"]),
                    ("resume", run.main, [f"ckpt_path={run_dir}", "trainer.max_epochs=2",
                                          f"hydra.run.dir={run2_dir}"]),
                    ("eval_model", eval_model.main, [f"ckpt_path={run2_dir}",
                                                     f"hydra.run.dir={eval_dir}"])):
                t0 = time.perf_counter()
                fn(base + extra)
                secs[name] = time.perf_counter() - t0
    finally:
        dm_module.read_store = saved_read
        if saved_wandb is None:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = saved_wandb
    recs = {d: read_metrics(p) for d, p in (("run", run_dir), ("run2", run2_dir),
                                              ("eval", eval_dir))}
    for d in ("run", "run2"):
        keys = set().union(*map(set, recs[d]))
        if keys != FLAGSHIP_METRIC_KEYS:
            raise AssertionError(f"bf16 {d} metric keys {sorted(keys ^ FLAGSHIP_METRIC_KEYS)}")
    if not all(math.isfinite(v) for d in recs for r in recs[d] for v in r.values()):
        raise AssertionError("a bf16 CLI metric is not finite")
    trained = sorted(r["epoch"] for r in recs["run2"] if "train_loss" in r)
    if trained != [1]:
        raise AssertionError(f"the bf16 resume trained epochs {trained}, expected [1]")
    (eval_test,) = recs["eval"]
    run2_test = [r for r in recs["run2"] if "test_mae_u" in r][-1]
    if ({k for k in run2_test if k.startswith("test_")}
            != {k for k in eval_test if k.startswith("test_")}):
        raise AssertionError(f"bf16 eval_model keys {sorted(eval_test)}")
    ckpt_root = os.path.join(run2_dir, "checkpoints")
    last = max(os.listdir(ckpt_root), key=int)
    saved = torch.load(os.path.join(ckpt_root, last, "state.pt"), map_location="cpu",
                       weights_only=False)
    dtypes = {t.dtype for part in ("params", "ema_params") for t in saved[part].values()}
    dtypes |= {t.dtype for m_ in ("mu", "nu") for t in saved["opt_state"][m_].values()}
    if dtypes != {torch.float32}:
        raise AssertionError(f"the bf16 run's checkpoint holds {dtypes}")
    for i, rec in enumerate(probe.steps):
        got = {k: rec["launches"][k] for k in per_step}
        if got != per_step:
            raise AssertionError(f"bf16 CLI train step {i}: launches {got}, "
                                 f"expected {per_step}")
    if len(probe.steps) != 4:
        raise AssertionError(f"{len(probe.steps)} bf16 CLI train steps, expected 2 + 2")
    step_ms = [r["s"] * 1e3 for r in probe.steps]
    emit({"phase": "bf16_train_cli", "config": CLI_CONFIG,
          "override": "trainer.precision=bf16", "seconds": secs,
          "data": "h5" if have["h5py"] else "in_memory",
          "train_step_ms": step_ms, "checkpoint_dtypes": sorted(map(str, dtypes)),
          "test_metrics": {k: run2_test[k] for k in sorted(run2_test)
                           if k.startswith("test_")},
          "eval_model_metrics": eval_test, "launches_per_step": per_step})
    shutil.rmtree(root)
    return {"seconds": secs}


def phase_bf16_training(device, hparams, params, b: int, fp32_launches: dict):
    """Phase 16: bf16 training of the flagship on the card (parts 1-3)."""
    m = hparams["model"]
    results = phase_bf16_backward(device, b, m["resolution"], m["ch"])
    launches = phase_bf16_train(device, hparams, params, b, fp32_launches)
    per_step = {k: launches[k] // TRAIN_STEPS for k in (
        "K2 gn_silu_conv", "K2 narrow_conv", "K4 attention", *BF16_BWD_KERNELS.values())}
    phase_bf16_train_cli(device, per_step)
    return results, launches


# ---------------------------------------------------------------------------
# Phase 17: the OFormer in bf16. K5's and K6's bf16 instances take bf16 k, v
# and q, K5 into fp32, K6 with its factor rounded to bf16 and its output
# rounded once; the OFormer's dense layers, norms and RoPE run in bf16 as the
# JAX package's flax modules with dtype=bfloat16 do (models/oformer.py).
# ---------------------------------------------------------------------------

# the bf16 instances, by the summary line's name, and their fp32 wrapper
LINEAR_BF16 = {"K5 kv_dots bf16": "K5 kv_dots", "K6 apply_dots bf16": "K6 apply_dots"}
# a ragged case: N not a multiple of a stage or a tile, widths 40 (TMA
# boxes of 64 columns, zero-filled past 40)
LINEAR_BF16_RAGGED = (3, 1000 + 37, 40)
# a BH whose clusters do not tile the 132 SMs (BH 20: four blocks a
# head-batch, 80 blocks), and a width that is not a multiple of 8 (rows TMA
# cannot describe: the bf16 mma.sync kernels, the workspace split)
LINEAR_BF16_MORE = ((20, 4096, 128, "BH 20, N 4096"), (3, 1000 + 37, 36, "width 36"))
# The bf16 OFormer, kernel path against the bf16 plain path: the two paths
# differ where K6's rounding flips a last bit (and the plain path's autograd
# rounds its backward elsewhere: it rounds the fp32 ddots to bf16 and keeps
# kv_dots' cotangent fp32), through six linear attentions a forward. The
# eval's metrics within 2e-2 relative (a correlation of scale 1), the
# prediction within 2e-2 of scale, each train step alone (from the plain
# path's state) within 2e-2 in loss and gradient norm, the params after three
# steps within 2 lr a step
TOL_OFORMER_BF16 = 2e-2
# K5/K6 bf16 outputs against float64 with the roundings the VJP makes: one
# rounding to bf16 (half an ulp) and the fp32 sum's own error
TOL_BF16_VS_FLOAT64 = 1e-2
# The metric keys the JAX package's run.main writes for config_oformer_t.yaml
# with one epoch (trainer.precision=bf16 or not), written down from one JAX
# run on tests/test_torch_cli.py's fixtures; that test holds the JAX run and
# the port's bf16 CLI on the CPU to this set
OFORMER_METRIC_KEYS = frozenset(
    {"epoch", "epoch_time_s", "time", "train_loss"}
    | {f"{split}_{k}" for split in ("val", "test")
       for k in ("corr", "loss", "mae_u", "mae_u_scaled", "mae_u_un", "pde_loss",
                 "pde_loss_gt")})
OFORMER_CLI_CONFIG = "config_oformer_t.yaml"


def scaled_vs(got, want, tol: float, name: str) -> float:
    """max |got - want| over max |want|; raises beyond tol."""
    import torch

    got, want = got.double(), want.double()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
    if err > tol:
        raise AssertionError(f"{name}: {err:.3e} of scale, beyond {tol:.0e}")
    return err


def phase_bf16_linear_attention(device, b: int, n: int, width: int, checks=None) -> dict:
    """Phase 17.1: K5's and K6's bf16 instances through their wrappers at
    the OFormer's shapes (BH = B and 4 B; N = n and n / 2, the time
    prediction's), the ragged case and LINEAR_BF16_MORE's: each against its
    bf16 plain version (K5's fp32 output within TOL_KERNEL of scale; K6's
    bf16 output within TOL_BF16 / TOL_BF16_MEAN, with an fp32 factor and,
    as a mode of its own, a bf16 one) and against float64 (K5 within
    TOL_KERNEL, K6 with its factor rounded, within TOL_BF16_VS_FLOAT64), the
    same bits on a repeat, each Function's backward against float64
    autograd of the plain forward (the cotangent, or the factor, rounded to
    bf16 as the VJP rounds it); the route (TMA where D and E are multiples
    of 8) and K5's cluster; kernel, plain and library times by CUDA events,
    the kernel's also on the card's clock (device_ms), and the bound: bf16
    bytes at 3.35 TB/s against bf16 products at 989 TFLOP/s. The library:
    for K5 the same function, torch.bmm(k^T, v, out_dtype=float32) (bf16
    torch.bmm with a bf16 output beside, as context); for K6 bf16
    torch.bmm with the factor in bf16. Then (linear_bf16_checks) the
    clusters the card holds at once, one device kernel a K5 call in the
    profiler, and the SASS of the TMA kernels, where `checks` does not
    already hold them. Returns the summaries keyed by LINEAR_BF16's names
    (BH = B at n), the other cases as modes."""
    import torch

    from m_cedm_tpu_torch.kernels import linear_attention as la

    g = torch.Generator(device=device).manual_seed(SEED + 60)
    smi = nvidia_smi_line()
    bf = torch.bfloat16
    active = la._active_clusters(device.index or 0)

    def rnd(*shape, dtype=bf):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    def k5_library(k, v):
        """The same function in one call, where the card's torch has the
        CUDA-only out_dtype overload of bmm, else None."""
        try:
            torch.bmm(k[:1, :64].transpose(1, 2), v[:1, :64], out_dtype=torch.float32)
        except (TypeError, RuntimeError):
            return None
        return lambda: torch.bmm(k.transpose(1, 2), v, out_dtype=torch.float32)

    cases = [(bh, nn, width, f"BH {bh}, N {nn}") for nn in (n, n // 2) for bh in (b, 4 * b)]
    bh_r, n_r, w_r = LINEAR_BF16_RAGGED
    cases.append((bh_r, n_r, w_r, "ragged"))
    cases.extend(LINEAR_BF16_MORE)
    results = {}
    for bh, nn, w, label in cases:
        q, k, v = (rnd(bh, nn, w) for _ in range(3))
        route = {"route": "tma" if la.tma_route(w, w) else "mma.sync",
                 "cluster": (la.kv_cluster(bh, nn, active) if la.tma_route(w, w)
                             else la._splits(bh, nn, device))}
        with torch.no_grad():
            dots = la.kv_dots_plain(k, v) / nn
            dots_bf = dots.to(bf)
            same_fn = k5_library(k, v)
            specs = (
                ("K5 kv_dots bf16", label, la.kv_dots, la.kv_dots_plain, (k, v),
                 same_fn, "torch.bmm(k^T, v, out_dtype=float32)" if same_fn else None),
                ("K6 apply_dots bf16", label, la.apply_dots, la.apply_dots_plain, (q, dots),
                 lambda: torch.bmm(q, dots_bf), "bf16 torch.bmm, the factor in bf16"),
                ("K6 apply_dots bf16", f"{label}, bf16 factor", la.apply_dots,
                 la.apply_dots_plain, (q, dots_bf), lambda: torch.bmm(q, dots_bf),
                 "bf16 torch.bmm"),
            )
            for name, case, fn, plain, args, library, library_name in specs:
                want = plain(*args)
                got = fn(*args)
                err = (compare(got, want, TOL_KERNEL, f"{name} {case}")
                       if got.dtype == torch.float32 else bf16_error(got, want, f"{name} {case}"))
                if not torch.equal(fn(*args), got):
                    raise AssertionError(f"{name} {case}: another result on a repeat")
                exact = (torch.bmm(k.double().transpose(1, 2), v.double())
                         if name.startswith("K5") else torch.bmm(q.double(), dots_bf.double()))
                err["vs_float64_max_rel_err"] = scaled_vs(
                    got, exact, TOL_KERNEL if got.dtype == torch.float32 else TOL_BF16_VS_FLOAT64,
                    f"{name} {case} vs float64")
                del exact
                flops = 2.0 * bh * nn * w * w
                rec = {"phase": "bf16_linear", "nvidia_smi": smi, "kernel": name,
                       "case": case, "bh": bh, "n": nn, "width": w, **route, **err,
                       "repeat_bit_for_bit": True, "ms": cuda_ms(lambda: fn(*args)),
                       "plain_ms": cuda_ms(lambda: plain(*args)),
                       "library": library_name,
                       "library_ms": cuda_ms(library) if library else None,
                       **bound(nbytes(*args, want), 0.0, bf16_flops=flops)}
                if name.startswith("K5"):
                    rec["library_bf16_out"] = "bf16 torch.bmm(k^T, v), a bf16 output (context)"
                    rec["library_bf16_out_ms"] = cuda_ms(lambda: torch.bmm(k.transpose(1, 2), v))
                rec["device_ms"] = device_ms(lambda: fn(*args), rec)
                rec["library_device_ms"] = (device_ms(library, rec) if library
                                            else None)
                del got, want
                rec.update(linear_bf16_backward(name, fn, args, g))
                emit(rec)
                if case == cases[0][3]:
                    results[name] = {**rec, "modes": {}}
                else:
                    results[name]["modes"][case] = {k_: rec[k_] for k_ in (
                        "route", "cluster", "ms", "device_ms", "plain_ms", "library_ms",
                        "library_device_ms", "library_bf16_out_ms", "bound_ms", "bound_by",
                        "max_rel_err", "vs_float64_max_rel_err", "backward_max_rel_err",
                        "backward_ms") if k_ in rec}
                    for key in ("max_abs_err", "max_rel_err"):
                        results[name][key] = max(results[name][key], rec[key])
        del q, k, v, dots, dots_bf
    torch.cuda.empty_cache()
    checks = checks or linear_bf16_checks(device, b, n, width)
    for name in results:
        results[name]["tma_checks"] = checks
    return results


def k1_bwd_bf16_checks(device, b: int, res: int, ch: int) -> dict:
    """K1's bf16 backward (gn_silu_bwd_cluster_kernel) at the train step's
    res-128 shape: exactly one device operation a call in torch.profiler (no
    buffer zeroed before it), and its plan; then the SASS of it and of
    conv_in's bf16 wgrad (wgrad_narrow_bf16_kernel<C>): K1 with no atomic
    or reduction on a floating type, every wgrad instance with its products
    on wgmma (HGMMA), no mma.sync and no fp32 FMA. main() runs it beside
    linear_bf16_checks, before the other phases' profiles."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from m_cedm_tpu_torch.kernels import _build
    from m_cedm_tpu_torch.kernels import fused_norm as fn
    from m_cedm_tpu_torch.models.layers import adm_groups

    g = torch.Generator(device=device).manual_seed(SEED + 71)
    n, groups = res * res, adm_groups(ch)
    x = torch.randn((b, n, ch), generator=g, device=device).bfloat16()
    gy = torch.randn((b, n, ch), generator=g, device=device).bfloat16()
    gamma = torch.randn((b, ch), generator=g, device=device) * 0.3 + 1.0
    beta = torch.randn((b, ch), generator=g, device=device) * 0.3
    stats = fn.channel_stats_plain(x)
    fn.gn_silu_bwd(gy, x, gamma, beta, stats, groups)
    torch.cuda.synchronize()
    calls = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn.gn_silu_bwd(gy, x, gamma, beta, stats, groups)
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    if len(ops) != calls or not all("gn_silu_bwd_cluster_kernel" in nm for nm in ops):
        raise AssertionError(f"K1 bf16 backward: {calls} calls ran the device operations {ops}")
    del x, gy
    sass = {}
    for name, c in _build.sass_counts("fused_norm", "gn_silu_bwd_cluster_kernel").items():
        sass["gn_silu_bwd_cluster_kernel"] = c
    for name, c in _build.sass_counts("fused_norm_conv_bwd", "wgrad_narrow_bf16_kernel").items():
        short = re.search(r"wgrad_narrow_bf16_kernelILi(\d)E", name)
        sass[f"wgrad_narrow_bf16_kernel<{short[1]}>" if short else name] = c
    k1 = sass.get("gn_silu_bwd_cluster_kernel")
    wgrads = {k: c for k, c in sass.items() if k.startswith("wgrad_narrow_bf16")}
    if not k1 or k1["FATOM"] or len(wgrads) != 8 or any(
            c["HGMMA"] == 0 or c["HMMA"] or c["FFMA"] for c in wgrads.values()):
        raise AssertionError(f"K1 bf16 backward / conv_in bf16 wgrad: SASS counts {sass}")
    out = {"k1_bwd_device_ops_per_call": len(ops) // calls,
           "plan": fn.bwd_bf16_plan(b, n, ch, groups, device), "sass": sass}
    emit({"phase": "bf16_k1_bwd_checks", **out})
    return out


def linear_bf16_checks(device, b: int, n: int, width: int) -> dict:
    """The clusters of 1 .. 8 blocks of the bf16 K5 on TMA that the card
    holds at once (cudaOccupancyMaxActiveClusters) and the cluster the
    wrapper takes at BH b and 4 b; exactly one device kernel a K5 call on
    the TMA route in torch.profiler (no workspace pass); and each TMA
    kernel's SASS: K5 and K6 on wgmma (HGMMA, no HMMA) fed by TMA loads
    (UTMALDG), K6 storing by TMA (UTMASTG). main() runs it before any other
    profile: late in the script, after the other phases' profiles, this
    profile of three calls read no device event at all (PERF.md section
    7)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from m_cedm_tpu_torch.kernels import _build
    from m_cedm_tpu_torch.kernels import linear_attention as la

    active = la._active_clusters(device.index or 0)
    k = torch.randn(b, n, width, device=device).bfloat16()
    la.kv_dots(k, k)
    torch.cuda.synchronize()
    calls = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            la.kv_dots(k, k)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    if len(kernels) != calls or not all("kv_dots_tma_kernel" in nm for nm in kernels):
        raise AssertionError(f"K5 bf16: {calls} calls ran the device kernels {kernels}")
    del k
    sass = {}
    for name, c in _build.sass_counts("linear_attention", "tma_kernel").items():
        short = re.search(r"\d((?:kv|apply)_dots_tma_kernel)(?:I(\w+?)EEv)?", name)
        sass[short[1] + (f"<{short[2]}>" if short[2] else "") if short else name] = c
    if len(sass) != 3 or any(c["HGMMA"] == 0 or c["HMMA"] or c["UTMALDG"] == 0
                             or ("apply" in nm and c["UTMASTG"] == 0)
                             for nm, c in sass.items()):
        raise AssertionError(f"bf16 K5 / K6 on TMA: SASS counts {sass}")
    out = {"active_clusters_1_to_8": list(active),
           "cluster_at_bh": {bh: la.kv_cluster(bh, n, active) for bh in (b, 4 * b)},
           "k5_device_kernels_per_call": len(kernels) // calls, "sass": sass}
    emit({"phase": "bf16_linear_checks", **out})
    return out


def linear_bf16_backward(name, fn, args, g) -> dict:
    """The Function's backward on bf16 leaves against float64 autograd of
    the einsum, with the rounding the VJP makes: kv_dots' fp32 cotangent
    rounded to bf16 (K6's factor), apply_dots' fp32 factor rounded to bf16;
    bf16 gradients within TOL_BF16_VS_FLOAT64, fp32 ones (apply_dots' ddots)
    within TOL_KERNEL. Also its time through autograd."""
    import torch

    with torch.enable_grad():
        return _linear_bf16_backward(name, fn, args, g)


def _linear_bf16_backward(name, fn, args, g) -> dict:
    import torch

    leaves = [a.detach().clone().requires_grad_() for a in args]
    out = fn(*leaves)
    if name.startswith("K5"):
        cot = torch.randn(out.shape, generator=g, device=out.device)
        eq, a64, c64 = "bnd,bne->bde", [a.double() for a in args], cot.to(torch.bfloat16)
    else:
        cot = torch.randn(out.shape, generator=g, device=out.device).to(torch.bfloat16)
        eq, c64 = "bnd,bde->bne", cot
        a64 = [args[0].double(), args[1].to(torch.bfloat16).double()]
    a64 = [a.requires_grad_() for a in a64]
    want = torch.autograd.grad(torch.einsum(eq, *a64), a64, c64.double())
    got = torch.autograd.grad(out, leaves, cot, retain_graph=True)
    errs = []
    for i, (a, w, leaf) in enumerate(zip(got, want, leaves, strict=True)):
        if a.dtype != leaf.dtype:
            raise AssertionError(f"{name} gradient {i}: {a.dtype}, its input {leaf.dtype}")
        tol = TOL_BF16_VS_FLOAT64 if a.dtype == torch.bfloat16 else TOL_KERNEL
        errs.append(scaled_vs(a, w, tol, f"{name} gradient {i} vs float64"))
    ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, cot, retain_graph=True),
                 runs=5, per_run=5)
    return {"backward_max_rel_err": max(errs), "backward_vs": "float64 autograd",
            "backward_ms": ms}


def check_bf16_launches(launches: dict, k5: int, k6: int, what: str) -> None:
    got = {k: launches[k] for k in (*LINEAR_BF16, *LINEAR_BF16.values())}
    want = {"K5 kv_dots bf16": k5, "K6 apply_dots bf16": k6, "K5 kv_dots": 0,
            "K6 apply_dots": 0}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def hold_metrics(got: dict, want: dict, tol: float, what: str) -> dict:
    """Relative difference of each metric (a correlation's of scale 1)."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: keys {sorted(got)} vs {sorted(want)}")
    out = {}
    for k, v in want.items():
        scale = max(1.0, abs(v)) if k.endswith("corr") else abs(v)
        if not math.isfinite(got[k]) or abs(got[k] - v) > tol * scale:
            raise AssertionError(f"{what} {k}: kernel path {got[k]} vs plain path {v}")
        out[k] = abs(got[k] - v) / scale
    return out


def phase_oformer_bf16(device, b: int, hparams=OFORMER_HPARAMS, target=OFORMER_TARGET,
                       phase: str = "oformer_bf16", seed: int = SEED + 70) -> dict:
    """Phases 17.2 (OformerTask) and 17.3 (OformerTimePredTask): the bf16
    task at full width and depth, kernel path against the bf16 plain path
    (PLAIN_OPS): one eval (launches asserted: 6 bf16 K5 and 6 bf16 K6, no
    fp32 one), then the bf16 and the fp32 kernel-path evals timed in turns;
    three train steps on both paths (12 / 24 bf16 launches a step
    asserted), a kernel-path step from each of the plain path's states
    held to TOL_OFORMER_BF16, the params after three steps within 2 lr a
    step, the master params and AdamW state fp32; the bf16 and fp32 steps
    timed in turns; one profiled bf16 step. Returns the eval's and a step's
    launches."""
    import torch

    from m_cedm_tpu_torch import kernels

    stats, batch, params, constants = oformer_setup(device, b, seed, hparams, target)
    # the bf16 task on both paths, and the fp32 task's kernel path (timed beside)
    ktask, ptask = oformer_tasks(device, {**hparams, "dtype": "bfloat16"}, target)
    k32 = oformer_tasks(device, hparams, target)[0]
    kstate, pstate, state32 = (t.init_state(None, stats, params=params, constants=constants)
                               for t in (ktask, ptask, k32))

    def run(task, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics, grid = task.eval_step(state, batch, split="val")
        torch.cuda.synchronize()
        return {k: float(v) for k, v in metrics.items()}, grid, time.perf_counter() - t0

    kernels.reset_launches()
    metrics, grid, _ = run(ktask, kstate)
    eval_launches = kernels.launches()
    check_bf16_launches(eval_launches, OFORMER_SITES, OFORMER_SITES, f"one {phase} eval")
    want = (b, int(batch[-1][0]), hparams["encoder"]["res"],
            hparams["decoder"]["out_channels"])
    if tuple(grid.shape) != want or grid.dtype != torch.float32:
        raise AssertionError(f"bf16 OFormer prediction {tuple(grid.shape)} {grid.dtype}")
    pmetrics, pgrid, _ = run(ptask, pstate)
    metric_err = hold_metrics(metrics, pmetrics, TOL_OFORMER_BF16, f"{phase} eval")
    pred_err = scaled_vs(grid, pgrid, TOL_OFORMER_BF16, f"{phase} prediction")
    m32, grid32, _ = run(k32, state32)
    walls, walls32 = [], []
    for _ in range(EVAL_RUNS):  # in turns: bf16, fp32, ...
        walls.append(run(ktask, kstate)[2])
        walls32.append(run(k32, state32)[2])

    kernels.reset_launches()
    kstates, kmetrics = [kstate], []
    for i in range(TRAIN_STEPS):
        st, m, _ = train_steps(ktask, kstates[-1], batch, device, i, 1)
        kstates.append(st)
        kmetrics += m
    step_launches = kernels.launches()
    check_bf16_launches(step_launches, 2 * OFORMER_SITES * TRAIN_STEPS,
                        4 * OFORMER_SITES * TRAIN_STEPS, f"{TRAIN_STEPS} {phase} train steps")
    pstates, pmetrics_t = [pstate], []
    for i in range(TRAIN_STEPS):
        st, m, _ = train_steps(ptask, pstates[-1], batch, device, i, 1)
        pstates.append(st)
        pmetrics_t += m
    alone = [train_steps(ktask, pstates[i], batch, device, i, 1)[1][0]
             for i in range(TRAIN_STEPS)]
    step_err = []
    for i, (km, pm) in enumerate(zip(alone, pmetrics_t, strict=True)):
        step_err.append({})
        for key in ("train_loss", "grad_norm"):
            rel = abs(km[key] - pm[key]) / abs(pm[key])
            if not math.isfinite(km[key]) or rel > TOL_OFORMER_BF16:
                raise AssertionError(f"{phase} step {i} {key}: kernel {km[key]} vs plain "
                                     f"{pm[key]}")
            step_err[-1][key] = rel
    lr = hparams["lr"]
    kfinal, pfinal = kstates[-1], pstates[-1]
    diff = max(float((kfinal.params[k] - pfinal.params[k]).abs().max()) for k in kfinal.params)
    if diff > 2 * lr * TRAIN_STEPS:
        raise AssertionError(f"{phase} params after {TRAIN_STEPS} steps differ by {diff}")
    dtypes = {t.dtype for t in kfinal.params.values()} | {
        t.dtype for m_ in ("mu", "nu") for t in kfinal.opt_state[m_].values()}
    if dtypes != {torch.float32}:
        raise AssertionError(f"{phase}: the bf16 state holds {dtypes}")
    kw, k32w = [], []
    s32 = state32
    for _ in range(2):  # in turns: bf16, fp32, bf16, fp32 (each 1 warm-up + 4 timed)
        kw += train_steps(ktask, kfinal, batch, device, TRAIN_STEPS, 5)[2][1:]
        s32, _, w32 = train_steps(k32, s32, batch, device, TRAIN_STEPS, 5)
        k32w += w32[1:]
    ms, ms32 = float(np.median(kw)) * 1e3, float(np.median(k32w)) * 1e3
    torch.cuda.reset_peak_memory_stats()
    train_steps(ktask, kfinal, batch, device, 50, 1)
    peak = torch.cuda.max_memory_allocated()
    prof = profile_step(ktask, kfinal, batch, device, ms / 1e3)
    emit({"phase": phase, "nvidia_smi": nvidia_smi_line(), "batch": b,
          "tokens": int(batch[0].shape[2]), "prop_tokens": int(batch[1].shape[2]),
          "metrics": metrics, "plain_metrics": pmetrics, "fp32_metrics": m32,
          "metrics_rel_err": metric_err, "prediction_rel_err": pred_err,
          "prediction_vs_fp32_rel_err": scaled_vs(grid, grid32, 1.0, ""),
          "tol": TOL_OFORMER_BF16,
          "eval_launches": {k: eval_launches[k] for k in LINEAR_BF16},
          "eval_wall_s": walls, "fp32_eval_wall_s": walls32,
          "ms_per_eval": float(np.median(walls)) * 1e3,
          "fp32_ms_per_eval": float(np.median(walls32)) * 1e3,
          "train_loss": [m["train_loss"] for m in kmetrics],
          "plain_train_loss": [m["train_loss"] for m in pmetrics_t],
          "grad_norm": [m["grad_norm"] for m in kmetrics],
          "plain_grad_norm": [m["grad_norm"] for m in pmetrics_t],
          "per_step_rel_err": step_err, "params_max_abs_diff": diff,
          "tol_params": 2 * lr * TRAIN_STEPS,
          "launches_per_step": {k: step_launches[k] / TRAIN_STEPS for k in LINEAR_BF16},
          "ms_per_step": ms, "fp32_ms_per_step": ms32,
          "step_ms": [w * 1e3 for w in kw], "fp32_step_ms": [w * 1e3 for w in k32w],
          "peak_memory_gib": peak / 2 ** 30, "profile": prof})
    return {"eval": {k: eval_launches[k] for k in LINEAR_BF16},
            "step": {k: step_launches[k] // TRAIN_STEPS for k in LINEAR_BF16}}


def phase_oformer_bf16_cli(device, per_step: dict, per_eval: dict) -> dict:
    """Phase 17.4: config_oformer_t.yaml with trainer.precision=bf16 through
    m_cedm_tpu_torch.run at full width and depth on phase 12's seeded fields
    (64 train and 16 test trajectories at res 128, in-memory stores where
    h5py is missing; system=swe_per): one epoch of 4 steps at batch 16 with
    validation and the test, a resume to epoch 2, then
    m_cedm_tpu_torch.eval_model on the resumed run with
    +model.hparams.dtype=bfloat16. Every metric finite, the keys the JAX
    package's (OFORMER_METRIC_KEYS), the resumed run trains epoch 1 only,
    the checkpoint's params and AdamW state fp32, each train step's and
    eval's launches those of 17.2 (bf16 K5 / K6 only); seconds, ms per
    step."""
    import importlib.util
    import os
    import shutil

    import torch

    from m_cedm_tpu_torch import eval_model, run
    from m_cedm_tpu_torch.data import datamodule as dm_module
    from m_cedm_tpu_torch.data.h5_io import write_store
    from m_cedm_tpu_torch.tasks.oformer import OformerTask

    have = {m: importlib.util.find_spec(m) is not None
            for m in ("h5py", "matplotlib", "wandb")}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "oformer_cli")
    shutil.rmtree(root, ignore_errors=True)
    sub = os.path.join(root, "1D_swp_128_per")
    os.makedirs(sub)
    stores = cli_stores(OFORMER_HPARAMS["encoder"]["res"])
    paths = {split: os.path.join(sub, f"1D_swp_128_per_{split}.h5") for split in stores}
    saved_read, saved_wandb = dm_module.read_store, sys.modules.get("wandb")
    if have["h5py"]:
        for split, st in stores.items():
            write_store(paths[split], st.inputs, st.targets, st.x, st.t)
    else:
        dm_module.read_store = {paths[split]: st for split, st in stores.items()}.__getitem__
    sys.modules["wandb"] = None
    job = ["--config-name", OFORMER_CLI_CONFIG, "system=swe_per", f"dataroot={root}",
           "trainer.precision=bf16", "callbacks=callbacks_save_model"]
    run_dir, run2_dir, eval_dir = (os.path.join(root, d) for d in ("run", "run2", "eval"))
    secs = {}
    try:
        with CliProbe(OformerTask) as probe:
            for name, fn, extra in (
                    ("fit", run.main, ["trainer.max_epochs=1", f"hydra.run.dir={run_dir}"]),
                    ("resume", run.main, [f"ckpt_path={run_dir}", "trainer.max_epochs=2",
                                          f"hydra.run.dir={run2_dir}"]),
                    ("eval_model", eval_model.main, [f"ckpt_path={run2_dir}",
                                                     "+model.hparams.dtype=bfloat16",
                                                     f"hydra.run.dir={eval_dir}"])):
                t0 = time.perf_counter()
                fn(job + extra)
                secs[name] = time.perf_counter() - t0
    finally:
        dm_module.read_store = saved_read
        if saved_wandb is None:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = saved_wandb
    recs = {d: read_metrics(p) for d, p in (("run", run_dir), ("run2", run2_dir),
                                              ("eval", eval_dir))}
    for d in ("run", "run2"):
        keys = set().union(*map(set, recs[d]))
        if keys != OFORMER_METRIC_KEYS:
            raise AssertionError(f"bf16 OFormer {d} metric keys "
                                 f"{sorted(keys ^ OFORMER_METRIC_KEYS)} differ")
    trained = sorted(r["epoch"] for r in recs["run2"] if "train_loss" in r)
    if trained != [1]:
        raise AssertionError(f"the bf16 OFormer resume trained epochs {trained}")
    run2_test = [r for r in recs["run2"] if "test_mae_u" in r][-1]
    (eval_test,) = recs["eval"]
    if ({k for k in run2_test if k.startswith("test_")}
            != {k for k in eval_test if k.startswith("test_")}):
        raise AssertionError(f"bf16 OFormer eval_model keys {sorted(eval_test)}")
    ckpt_root = os.path.join(run2_dir, "checkpoints")
    last = max(os.listdir(ckpt_root), key=int)
    saved = torch.load(os.path.join(ckpt_root, last, "state.pt"), map_location="cpu",
                       weights_only=False)
    dtypes = {t.dtype for t in saved["params"].values()}
    dtypes |= {t.dtype for m_ in ("mu", "nu") for t in saved["opt_state"][m_].values()}
    if dtypes != {torch.float32}:
        raise AssertionError(f"the bf16 OFormer checkpoint holds {dtypes}")
    zero = {"K5 kv_dots": 0, "K6 apply_dots": 0}
    for what, recs_, want in (("train step", probe.steps, {**per_step, **zero}),
                              ("eval", probe.evals, {**per_eval, **zero})):
        for i, rec in enumerate(recs_):
            got = {k: rec["launches"][k] for k in want}
            if got != want:
                raise AssertionError(f"bf16 OFormer CLI {what} {i}: launches {got}, "
                                     f"expected {want}")
    if len(probe.steps) != 8:
        raise AssertionError(f"{len(probe.steps)} bf16 OFormer CLI train steps, "
                             f"expected 4 + 4")
    step_ms = [r["s"] * 1e3 for r in probe.steps]
    emit({"phase": "oformer_bf16_cli", "config": OFORMER_CLI_CONFIG,
          "nvidia_smi": nvidia_smi_line(), "override": "trainer.precision=bf16",
          "seconds": secs, "data": "h5" if have["h5py"] else "in_memory",
          "train_step_ms": step_ms, "checkpoint_dtypes": sorted(map(str, dtypes)),
          "test_metrics": {k: run2_test[k] for k in sorted(run2_test) if k.startswith("test_")},
          "eval_model_metrics": eval_test, "launches_per_step": per_step,
          "launches_per_eval": per_eval})
    shutil.rmtree(root)
    return {"seconds": secs}


def phase_oformer_bf16_all(device, b: int, linear_checks=None) -> tuple:
    """Phase 17: the OFormer in bf16 on the card (parts 1-4), with
    linear_bf16_checks' result where main() took it first. Returns the bf16
    K5 / K6 summaries and their launches in 17.2's eval and step and
    17.3's."""
    enc = OFORMER_HPARAMS["encoder"]
    results = phase_bf16_linear_attention(device, b, enc["res"] ** 2, enc["in_emb_dim"],
                                          linear_checks)
    recon = phase_oformer_bf16(device, b)
    timepred = phase_oformer_bf16(device, b, TIMEPRED_HPARAMS, TIMEPRED_TARGET,
                                  "timepred_bf16", SEED + 71)
    phase_oformer_bf16_cli(device, recon["step"], recon["eval"])
    return results, recon, timepred


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    from m_cedm_tpu_torch.kernels._launch import fp32_reference_math

    fp32_reference_math()
    device = torch.device("cuda", 0)
    hparams = FLAGSHIP_HPARAMS
    m = hparams["model"]
    phase_device()
    enc = OFORMER_HPARAMS["encoder"]
    linear_checks = linear_bf16_checks(device, BATCH, enc["res"] ** 2, enc["in_emb_dim"])
    k1_bwd_checks = k1_bwd_bf16_checks(device, BATCH, m["resolution"], m["ch"])
    results = phase_kernels(device, BATCH, m["resolution"], m["ch"])
    results.update(phase_backward(device, BATCH, m["resolution"], m["ch"]))
    params = phase_forward(device, hparams, BATCH)
    eval_launches, eval_metrics = phase_eval(device, hparams, params, BATCH)
    train_launches = phase_train(device, hparams, params, BATCH)
    results.update(phase_linear_attention(device, BATCH, enc["res"] ** 2, enc["in_emb_dim"]))
    eval_launches.update(
        {k: v for k, v in phase_oformer_eval(device, BATCH).items() if k in OFORMER_KERNELS})
    oformer_step_launches, _ = phase_oformer_train(device, BATCH)
    results.update(phase_mega_kernel(device, BATCH, m["resolution"], m["ch"]))
    mega_launches = phase_mega_eval(device, hparams, params, BATCH, eval_metrics)
    eval_launches.update({k: mega_launches[k] for k in MEGA_KERNELS})
    cond_launches = phase_cond_edm(device, BATCH)
    cli_launches, cli_run2, cli_eval = phase_cli(device, params)
    at_32_groups = phase_ddpm_kernels(device, BATCH)
    ddim_launches = phase_ddim(device, BATCH)
    phase_cond_baselines(device, BATCH)
    phase_ddim_cli(device)
    fno = phase_fno(device, FNO_BATCH)
    phase_fno_cli(device)
    timepred_eval = phase_oformer_eval(device, BATCH, TIMEPRED_HPARAMS, TIMEPRED_TARGET,
                                       "timepred_eval", SEED + 44)
    timepred_step, timepred_state = phase_oformer_train(
        device, BATCH, TIMEPRED_HPARAMS, TIMEPRED_TARGET, "timepred_train", SEED + 45,
        TOL_TIMEPRED_TRAJECTORY)
    at_n_8192 = phase_linear_attention(device, BATCH, TIMEPRED_HISTORY * enc["res"],
                                       enc["in_emb_dim"])
    phase_two_stage(device, fno, timepred_state.params, timepred_state.constants)
    bf16_results, bf16_launches, bf16_mega = phase_bf16(
        device, hparams, params, BATCH, eval_launches, cli_run2, cli_eval, mega_launches)
    bwd16_results, bwd16_launches = phase_bf16_training(device, hparams, params, BATCH,
                                                        train_launches)
    linear16, oformer16, timepred16 = phase_oformer_bf16_all(device, BATCH, linear_checks)
    bf16_results.update(linear16)
    bf16_launches = {**bf16_launches, **oformer16["eval"]}
    summary = []
    for name, (source, replaces) in KERNEL_INFO.items():
        rec = results[name]
        launches = (train_launches if name.endswith("_bwd") else eval_launches)[name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches,
               "max_abs_err": rec["max_abs_err"],
               "max_rel_err": rec["max_rel_err"], "tol": rec["tol"],
               "ms": rec["ms"], "plain_ms": rec["plain_ms"],
               "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
               "library_ms": rec["library_ms"]}
        for key in ("kernel_call_ms", "device_ms", "old_route_ms", "old_route_call_ms",
                    "bound_fp32_ms", "act_false_modes", "backward_ms",
                    "backward_library_ms", "backward_bound_ms", "wgrad_call_ms",
                    "dgrad_call_ms", "conv2d_conv_only_bwd_ms", "context_ms",
                    "at_res_64"):
            if key in rec:
                row[key] = rec[key]
        if name in OFORMER_KERNELS:
            row.update(launches_per_train_step=oformer_step_launches[name],
                       at_bh_64=rec["at_bh_64"],
                       launches_timepred_eval=timepred_eval[name],
                       launches_timepred_step=timepred_step[name],
                       at_n_8192={k: at_n_8192[name][k] for k in
                                  LINEAR_KEYS + ("max_abs_err", "max_rel_err", "at_bh_64")})
        if name in FLAGSHIP_KERNELS:
            row.update(launches_cli=cli_launches[name])
        if name in DDPM_KERNELS:
            row.update(launches_ddim_eval=ddim_launches["eval"][name],
                       launches_ddim_step=ddim_launches["step"][name])
        prefix = {"K2 gn_silu_conv": "K2 ", "K1 gn_silu": "K1 "}.get(name)
        if prefix:
            row["at_32_groups"] = {case: rec for case, rec in at_32_groups.items()
                                   if case.startswith(prefix)}
        if name in MEGA_KERNELS:
            row.update(two_kernel_ms=rec["two_kernel_ms"],
                       backward_max_rel_err=rec["backward_max_rel_err"],
                       launches_cond_edm_eval=cond_launches[name])
        summary.append(row)
    for name, fp32_name in BF16_KERNELS.items():
        rec = bf16_results[name]
        source, replaces = KERNEL_INFO[fp32_name]
        # K5's and K6's bf16 instances count apart from their fp32 ones
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "dtype": "bfloat16",
               "launches": bf16_launches[name if name in LINEAR_BF16 else fp32_name],
               "max_abs_err": rec["max_abs_err"],
               "max_rel_err": rec["max_rel_err"],
               "mean_rel_err": rec.get("mean_rel_err"), "tol": rec["tol"],
               "tol_mean": rec.get("tol_mean"), "ms": rec["ms"],
               "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
               "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
               "modes": rec["modes"],
               **{k: rec[k] for k in K4_BF16_KEYS if k in rec}}
        if name in LINEAR_BF16:
            row.update(launches_per_train_step=oformer16["step"][name],
                       launches_timepred_eval=timepred16["eval"][name],
                       launches_timepred_step=timepred16["step"][name],
                       backward_max_rel_err=rec["backward_max_rel_err"],
                       backward_ms=rec["backward_ms"], device_ms=rec["device_ms"],
                       library=rec["library"], library_device_ms=rec["library_device_ms"],
                       route=rec["route"], cluster=rec["cluster"],
                       tma_checks=rec["tma_checks"])
            if "library_bf16_out_ms" in rec:
                row["library_bf16_out_ms"] = rec["library_bf16_out_ms"]
        summary.append(row)
    rec = bf16_results[MEGA_BF16]
    source, replaces = KERNEL_INFO["K7 unet_block"]
    summary.append({"name": MEGA_BF16, "route": "cuda", "source": source,
                    "replaces": replaces, "dtype": "bfloat16",
                    "launches": bf16_mega["eval"]["K7 unet_block"],
                    "launches_cond_edm_eval": bf16_mega["cond_edm"]["K7 unet_block"],
                    **{k: rec[k] for k in (
                        "max_abs_err", "max_rel_err", "mean_rel_err", "tol", "tol_mean",
                        "stats_max_rel_err", "stats_tol", "ms", "device_ms", "plain_ms",
                        "bound_ms", "bound_by", "library_ms", "two_kernel_ms",
                        "two_kernel_device_ms", "device_ms_per_forward",
                        "two_kernel_device_ms_per_forward", "bound_ms_per_forward", "modes",
                        "sass")}})
    for name, fp32_name in BF16_BWD_KERNELS.items():
        rec = bwd16_results[name]
        source, replaces = KERNEL_INFO.get(fp32_name) or BF16_ONLY_INFO[fp32_name]
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "dtype": "bfloat16", "launches": bwd16_launches[fp32_name],
               "launches_per_step": bwd16_launches[fp32_name] / TRAIN_STEPS,
               "max_abs_err": rec["max_abs_err"], "max_rel_err": rec["max_rel_err"],
               "ms": rec["ms"], "device_ms": rec["device_ms"],
               "fp32_device_ms": rec.get("fp32_device_ms"), "plain_ms": rec["plain_ms"],
               "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
               "library_ms": rec["library_ms"], "modes": rec["modes"]}
        if "o32_max_rel_err" in rec:
            row["o32_max_rel_err"] = rec["o32_max_rel_err"]
        row.update({k: rec[k] for k in ("conv_in_wgrad", "wgrad_library_device_ms")
                    if k in rec})
        if name == "K1 gn_silu_bwd bf16":
            row["checks"] = k1_bwd_checks
        row.update({k: rec[k] for k in K4_BF16_KEYS if k in rec})
        summary.append(row)
    emit({"kernels": summary})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
