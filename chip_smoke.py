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
              the same operands)
  3. forward  one full-width U-Net forward (B = 16, res 128, ch 64, the four
              attention sites), kernel path against the plain path
  2b. backward each backward kernel against autograd of its plain forward at
              the flagship shapes (every K2 mode the U-Net's train step
              uses), every gradient output's max abs and relative error
              beside the tolerance, kernel vs plain time of the backward
              alone, and scaled_dot_product_attention's time for K4 and
              conv2d's autograd backward for K2's linear modes; the narrow
              backward (the out conv) also called directly beside the old
              route's kernels (K2's dgrad and wgrad) on the same operands
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
              to each other, K2's launches per step asserted; then ms per step on both paths (median of the
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
              K3 + K2) times; its recompute backward against float64
              autograd of the plain composition
  10. mega eval   phase 4's eval (same state and noise) with mega=True:
              metrics within 1e-4 of the per-conv kernel path, the observed
              channel held, launches asserted (13 K7, 4 K2, 2 narrow, 0 K3 and
              4 K4 per forward), samples/s of both paths in turns
  11. cond edm    CondEdmTask of configs/model/adm_edm_cond_h_res32.yaml at B =
              16, full width and depth, 50 Heun steps with S_churn 15, on the
              kernel path with mega=True and on the plain path: metrics
              within 1e-4, the sample of both paths within 1e-4 of scale,
              launches asserted, samples/s of both

Then the per-kernel summary line {"kernels": [...]} (flagship forward
launches counted in the kernel-path eval of phase 4, backward launches in the
kernel-path train steps of phase 5; K5 and K6 in one OFormer eval of phase 7,
with their launches per OFormer train step beside; K7 in the mega eval of
phase 10, with phase 11's beside), the nvidia-smi line, and the last line
names the device. `bound_ms` is the least time the card could take for a kernel's work
at the timed shape: the larger of its bytes (each input read once, each
output written once) over 3.35 TB/s and its FLOPs over the 67 TFLOP/s fp32
peak of an H100 SXM for the kernels that run fp32 on the CUDA cores; K2/K3
(gnsc_kernel), K4, K5 and K6 run their products as 3xTF32 on the tensor
cores: three TF32 FLOPs per fp32 FLOP over the 495 TFLOP/s TF32 peak (their
CUDA-core bound beside, as `bound_fp32_ms`). K2's linear modes are listed in its rows
and in the narrow kernel's under `act_false_modes`, each with its time,
bound and conv2d time (the narrow kernel's with the old route's time). The plain versions
run with TF32 off (kernels._launch.fp32_reference_math). Every failed check
raises, so the exit code is non-zero; with no CUDA device the script exits 2
before printing any result.
"""
from __future__ import annotations

import json
import math
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
# 16,384, in fp32 through fp32 atomics in no fixed order; the rounding of
# such a sum grows with its length, so the bound is 1e-4 of the gradient's
# scale, with the JAX package's 1e-3 against the torch reference as the
# ceiling.
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
# With mega=True: K7 runs the 13 blocks that are not down blocks (three
# encoder blocks, the two middle blocks, six decoder blocks, two up blocks);
# K2 the two down blocks' two convs, the narrow kernel conv_in and out_conv;
# K4 the four attention sites; no K3 (the up blocks are K7's)
MEGA_LAUNCHES = {"K7 unet_block": 13, "K2 gn_silu_conv": 4, "K2 narrow_conv": 2,
                 "K3 gn_silu_up_conv": 0, "K4 attention": 4}
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


def bound(nbytes: float, flops: float, tf32_products: int = 0) -> dict:
    """The least time the card could take: bytes over the memory rate or
    FLOPs over the fp32 rate, whichever is longer. A kernel whose fp32
    products run as `tf32_products` TF32 products on the tensor cores (3 for
    3xTF32) does that many TF32 FLOPs per fp32 FLOP over the TF32 rate; its
    fp32 CUDA-core bound is kept beside as `bound_fp32_ms`."""
    t_bytes, t_fp32 = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    t_ops = tf32_products * flops / PEAK_TF32 * 1e3 if tf32_products else t_fp32
    rec = {"bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "flops": flops}
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
                  "bound_ms", "bound_by", "max_rel_err", "old_route_ms",
                  "kernel_call_ms", "old_route_call_ms")


def nbytes(*tensors) -> int:
    return sum(4 * t.numel() for t in tensors if t is not None)


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
              old_fn=None):
        """`work`: (bytes, flops[, tf32 products]) of the kernel's call, given
        for the mode whose time the summary line reports (each kernel's
        first). `lib_fn`: the PyTorch call computing the same function, timed
        beside (its error against the plain version recorded, not held).
        `old_fn`: the route the kernel replaced, held to the plain version
        and timed beside."""
        errs = [compare(a, w, TOL_KERNEL, f"{kernel} {mode} output {i}")
                for i, (a, w) in enumerate(zip(flat(got), flat(want), strict=True))]
        rec = {"phase": "kernel", "kernel": kernel, "mode": mode,
               **max(errs, key=lambda e: e["max_rel_err"]),
               "outputs_checked": len(errs)}
        rec["ms"] = cuda_ms(k_fn)
        rec["plain_ms"] = cuda_ms(p_fn)
        if work is not None:
            rec.update(bound(*work), library_ms=None)
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
        check("K1 channel_stats", "(B,N,C)", fn.channel_stats(x), stats,
              lambda: fn.channel_stats(x), lambda: fn.channel_stats_plain(x),
              work=(nbytes(x, *stats), 3.0 * x.numel()))
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

    def check(kernel, mode, kernel_fn, plain_fn, inputs, work=None, lib_fn=None):
        """kernel_fn / plain_fn map the inputs to the output whose cotangent
        is a seeded normal. Every input's gradient is held to autograd of the
        plain forward in float64 on the same inputs (the fp32 plain path's
        own error against it is reported beside the kernel's); the times are
        of the fp32 backward on each path. `lib_fn`, a PyTorch call computing
        the same forward, has its backward timed beside (its error recorded,
        not held)."""
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
        emit(rec)
        keep_result(results, rec)
        if lib_fn is not None:
            results[kernel].setdefault("act_false_modes", []).append(
                {k: rec[k] for k in ACT_FALSE_KEYS if k in rec})
        return rec

    # K1 backward: the down-block prefix and the out-head norm, (B, N, C)
    n = res * res
    x = rnd(b, n, ch, scale=0.8, shift=0.2)
    gamma, beta = fold(ch)
    gr = adm_groups(ch)
    with torch.no_grad():
        stats = fn.channel_stats_plain(x)
    check("K1 gn_silu_bwd", "chained stats",
          lambda *a: fn.gn_silu(*a, gr, stats=stats),
          lambda *a: fn.gn_silu_plain(*a, gr), (x, gamma, beta),
          work=(nbytes(x, x, x, gamma, beta, *stats, gamma, beta),
                20.0 * x.numel()))

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
        work = (nbytes(x, gamma, beta, w, *(stats or ()), *[kw[k] for k in names],
                       torch.empty(b_, h_, w_, o, device="meta"), *outs, w, bias),
                conv_flops(b_, h_, w_, c_, o) * (2 if need_da else 1))
        return check(kernel, mode, run(fnc.gn_silu_conv, stats),
                     run(drop_stats(fnc.gn_silu_conv_plain), None),
                     [x, gamma, beta, w, bias] + [kw[k] for k in names],
                     work=work, lib_fn=None if act else (
                         lambda x, gamma, beta, w, bias: conv2d_library(x, w, bias)))

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
                2 * conv_flops(b, res, res, ch, ch)))

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
            "K2 gn_silu_conv_bwd": K2_BWD_PER_STEP * TRAIN_STEPS}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"{TRAIN_STEPS} train steps: K2 launches "
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
                rec = {"phase": "linear", "kernel": name, "bh": bh, "n": n,
                       "width": width,
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


def oformer_setup(device, b: int, seed: int):
    """The OFormer's own init drawn from a seeded generator (fan-in-scaled
    lecun-normal dense layers, the orthogonal-plus-diagonal q/k/v blocks,
    the Fourier matrix B; no layer starts at zero, so every kernel's work
    shows), and seeded synthetic shallow-water fields on the 128 x 128 grid,
    tokenized as the OFormer datamodule does (h in, u out)."""
    import torch

    from m_cedm_tpu_torch.data.oformer_data import tokenize_grid
    from m_cedm_tpu_torch.tasks import build_task

    res = OFORMER_HPARAMS["encoder"]["res"]
    h, _, _, u = synthetic_swe_batch(np.random.RandomState(seed), b, res)
    stats = {"input_mean": h.mean(), "input_std": h.std(),
             "target_mean": u.mean(), "target_std": u.std()}
    t = np.broadcast_to(np.linspace(0.0, 1.0, res, dtype=np.float32), (b, res))
    x = np.broadcast_to(np.linspace(-2.5, 2.5, res, dtype=np.float32), (b, res))
    tok = tokenize_grid(h, u, x, t, stats)
    batch = tuple(torch.from_numpy(np.ascontiguousarray(tok[k])).to(device)
                  for k in ("x", "y", "node_type", "pos", "n_time"))
    fresh = build_task(OFORMER_HPARAMS, "cpu", target=OFORMER_TARGET).init_state(
        torch.Generator().manual_seed(seed))
    return stats, batch, fresh.params, fresh.constants


def oformer_tasks(device):
    from m_cedm_tpu_torch import kernels
    from m_cedm_tpu_torch.tasks import build_task

    return [build_task(OFORMER_HPARAMS, device, target=OFORMER_TARGET, ops=ops,
                       grad_clip=OFORMER_GRAD_CLIP)
            for ops in (kernels.DEVICE_OPS, kernels.PLAIN_OPS)]


def check_oformer_launches(launches: dict, k5: int, k6: int, what: str) -> None:
    got = (launches["K5 kv_dots"], launches["K6 apply_dots"])
    if got != (k5, k6):
        raise AssertionError(f"{what}: K5, K6 launched {got} times, expected {(k5, k6)}")


def phase_oformer_eval(device, b: int) -> dict:
    """OformerTask.eval_step at full width and depth on both paths."""
    import torch

    from m_cedm_tpu_torch import kernels

    stats, batch, params, constants = oformer_setup(device, b, SEED + 7)
    ktask, ptask = oformer_tasks(device)
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
    check_oformer_launches(launches, OFORMER_SITES, OFORMER_SITES, "one OFormer eval")
    res = OFORMER_HPARAMS["encoder"]["res"]
    if tuple(grid.shape) != (b, res, res, 1) or not torch.isfinite(grid).all():
        raise AssertionError(f"OFormer prediction {tuple(grid.shape)} not finite")
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
    emit({"phase": "oformer_eval", "batch": b, "tokens": int(batch[0].shape[2]),
          "metrics": metrics, "plain_metrics": pmetrics, "metrics_tol": TOL_METRICS,
          "prediction": compare(grid, pgrid, TOL_FORWARD, "OFormer prediction"),
          "launches": {k: launches[k] for k in OFORMER_KERNELS},
          "wall_s": walls, "plain_wall_s": pwalls,
          "ms_per_eval": float(np.median(walls)) * 1e3,
          "plain_ms_per_eval": float(np.median(pwalls)) * 1e3})
    return launches


def phase_oformer_train(device, b: int) -> dict:
    """Three OformerTask.train_steps from one state on both paths, then
    timing, one profiled step and the peak memory of a step."""
    import torch

    from m_cedm_tpu_torch import kernels

    stats, batch, params, constants = oformer_setup(device, b, SEED + 8)
    ktask, ptask = oformer_tasks(device)
    kstate, pstate = (t.init_state(None, stats, params=params, constants=constants)
                      for t in (ktask, ptask))
    kernels.reset_launches()
    kfinal, kmetrics, _ = train_steps(ktask, kstate, batch, device, 0, TRAIN_STEPS)
    launches = kernels.launches()
    check_oformer_launches(launches, 2 * OFORMER_SITES * TRAIN_STEPS,
                           4 * OFORMER_SITES * TRAIN_STEPS,
                           f"{TRAIN_STEPS} OFormer train steps")
    pstates, pmetrics = [pstate], []
    for i in range(TRAIN_STEPS):  # the plain path step by step, keeping its states
        st, m, _ = train_steps(ptask, pstates[-1], batch, device, i, 1)
        pstates.append(st)
        pmetrics += m
    pfinal = pstates[-1]

    def hold(metrics, what):
        for step, (km, pm) in enumerate(zip(metrics, pmetrics, strict=True)):
            for key in ("train_loss", "grad_norm"):
                if (not math.isfinite(km[key])
                        or abs(km[key] - pm[key]) > TOL_TRAIN * abs(pm[key])):
                    raise AssertionError(f"OFormer {what} step {step} {key}: kernel "
                                         f"{km[key]} vs plain {pm[key]}")

    # one kernel-path step from each of the plain path's states: the step
    # itself, without the growth of a rounding difference along the
    # trajectory (the gradient norm grows about sevenfold a step)
    step_metrics = [train_steps(ktask, pstates[i], batch, device, i, 1)[1][0]
                    for i in range(TRAIN_STEPS)]
    hold(step_metrics, "per-step")
    hold(kmetrics, "trajectory")
    lr = OFORMER_HPARAMS["lr"]
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
    emit({"phase": "oformer_train", "batch": b, "steps": TRAIN_STEPS,
          "train_loss": [m["train_loss"] for m in kmetrics],
          "plain_train_loss": [m["train_loss"] for m in pmetrics],
          "grad_norm": [m["grad_norm"] for m in kmetrics],
          "plain_grad_norm": [m["grad_norm"] for m in pmetrics],
          "per_step_train_loss": [m["train_loss"] for m in step_metrics],
          "per_step_grad_norm": [m["grad_norm"] for m in step_metrics],
          "tol": TOL_TRAIN, "params_max_abs_diff": diff,
          "tol_params": 2 * lr * TRAIN_STEPS, "params_moved_max": moved,
          "launches_per_step": {k: launches[k] / TRAIN_STEPS for k in OFORMER_KERNELS},
          "ms_per_step": ms, "plain_ms_per_step": pms,
          "step_ms": [w * 1e3 for w in kwalls],
          "plain_step_ms": [w * 1e3 for w in pwalls],
          "peak_memory_gib": peak / 2 ** 30, "profile": prof})
    return {k: launches[k] // TRAIN_STEPS for k in OFORMER_KERNELS}


def two_kernel_block(x, g0, b0, w0, bias0, g1, b1, w1, bias1, groups0, groups1,
                     eps, *, x2=None, skip_w=None, skip_b=None, stats=None,
                     emit_stats=False, up=False):
    """The U-Net's per-conv path for one block (mega=False): K2 conv0 (or K3
    for an up block) emitting its statistics, then the K2 tail; a decoder's
    concat is made first. The yardstick K7 replaces."""
    import torch

    from m_cedm_tpu_torch.kernels import fused_norm_conv as fnc

    xin = torch.cat([x, x2], dim=-1) if x2 is not None else x
    if up:
        h, hs = fnc.gn_silu_up_conv(xin, g0, b0, w0, bias0, groups0, eps,
                                    stats=stats, emit_stats=True)
        tail = dict(residual=xin, res_up=True)
    else:
        h, hs = fnc.gn_silu_conv(xin, g0, b0, w0, bias0, groups0, eps, stats=stats,
                                 emit_stats=True)
        tail = dict(residual=xin, skip_w=skip_w, skip_b=skip_b)
    return fnc.gn_silu_conv(h, g1, b1, w1, bias1, groups1, eps, stats=hs,
                            emit_stats=emit_stats, **tail)


def phase_mega_kernel(device, b: int, res: int, ch: int) -> dict:
    """K7 against its plain version, one case per variant the U-Net runs at
    the flagship's shapes and the ragged case of the CUDA tests; kernel,
    plain and two-kernel-path times; the recompute backward against float64
    autograd of the plain composition. Returns the identity case's summary."""
    import torch

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
                   **bound(nbytes(*tensors), flops), "library_ms": None,
                   "library": "none: no PyTorch call computes a whole ADM block"}
        if first is None:
            rec["occupancy_blocks_per_sm_x_sms"] = fb.occupancy(False)
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
    results = phase_kernels(device, BATCH, m["resolution"], m["ch"])
    results.update(phase_backward(device, BATCH, m["resolution"], m["ch"]))
    params = phase_forward(device, hparams, BATCH)
    eval_launches, eval_metrics = phase_eval(device, hparams, params, BATCH)
    train_launches = phase_train(device, hparams, params, BATCH)
    enc = OFORMER_HPARAMS["encoder"]
    results.update(phase_linear_attention(device, BATCH, enc["res"] ** 2, enc["in_emb_dim"]))
    eval_launches.update(
        {k: v for k, v in phase_oformer_eval(device, BATCH).items() if k in OFORMER_KERNELS})
    oformer_step_launches = phase_oformer_train(device, BATCH)
    results.update(phase_mega_kernel(device, BATCH, m["resolution"], m["ch"]))
    mega_launches = phase_mega_eval(device, hparams, params, BATCH, eval_metrics)
    eval_launches.update({k: mega_launches[k] for k in MEGA_KERNELS})
    cond_launches = phase_cond_edm(device, BATCH)
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
        for key in ("kernel_call_ms", "old_route_ms", "old_route_call_ms",
                    "bound_fp32_ms", "act_false_modes", "backward_ms",
                    "backward_library_ms", "backward_bound_ms"):
            if key in rec:
                row[key] = rec[key]
        if name in OFORMER_KERNELS:
            row.update(launches_per_train_step=oformer_step_launches[name],
                       at_bh_64=rec["at_bh_64"])
        if name in MEGA_KERNELS:
            row.update(two_kernel_ms=rec["two_kernel_ms"],
                       backward_max_rel_err=rec["backward_max_rel_err"],
                       launches_cond_edm_eval=cond_launches[name])
        summary.append(row)
    emit({"kernels": summary})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
