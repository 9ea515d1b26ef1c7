#!/usr/bin/env python3
"""Drive the PyTorch port (m_cedm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each printing JSON lines:
  1. device   the card (nvidia-smi name and power limit), torch and CUDA
              versions, and the seconds nvcc took to build the kernels
  2. kernel   each CUDA kernel against its plain PyTorch version at the
              flagship shapes (every K2 mode the U-Net uses), with max abs and
              relative error beside the tolerance, and kernel vs plain time
              (CUDA events, median of 10 runs of 10 back-to-back calls)
  3. forward  one full-width U-Net forward (B = 16, res 128, ch 64, the four
              attention sites), kernel path against the plain path
  4. eval     McedmTask.eval_step for mask task "u" at B = 16 with the
              flagship sampler (50 Heun steps, S_churn 15) on seeded synthetic
              shallow-water fields, on the kernel path with every launch
              counter read; then the plain path and the kernel path in turns,
              three timed evals each (median reported), and the two paths'
              metrics held to each other

Then the per-kernel summary line {"kernels": [...]} (launches counted in the
kernel-path eval of phase 4), and the last line names the device. The plain
versions run with TF32 off (kernels._launch.fp32_reference_math). Every
failed check raises, so the exit code is non-zero; with no CUDA device the
script exits 2 before printing any result.
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

KERNEL_INFO = {
    "K1 gn_silu": ("m_cedm_tpu_torch/csrc/fused_norm.cu",
                   "m_cedm_tpu/pallas/fused_norm.py:132"),
    "K1 channel_stats": ("m_cedm_tpu_torch/csrc/fused_norm.cu",
                         "m_cedm_tpu/pallas/fused_norm.py:119"),
    "K2 gn_silu_conv": ("m_cedm_tpu_torch/csrc/fused_norm_conv.cu",
                        "m_cedm_tpu/pallas/fused_norm_conv.py:182"),
    "K3 gn_silu_up_conv": ("m_cedm_tpu_torch/csrc/fused_norm_conv.cu",
                           "m_cedm_tpu/pallas/fused_norm_conv.py:1070"),
    "K4 attention": ("m_cedm_tpu_torch/csrc/fused_attention.cu",
                     "m_cedm_tpu/pallas/fused_attention.py:48"),
}


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

    def check(kernel, mode, got, want, k_fn, p_fn):
        errs = [compare(a, w, TOL_KERNEL, f"{kernel} {mode} output {i}")
                for i, (a, w) in enumerate(zip(flat(got), flat(want), strict=True))]
        rec = {"phase": "kernel", "kernel": kernel, "mode": mode,
               **max(errs, key=lambda e: e["max_rel_err"]),
               "outputs_checked": len(errs)}
        rec["ms"] = cuda_ms(k_fn)
        rec["plain_ms"] = cuda_ms(p_fn)
        emit(rec)
        prev = results.get(kernel)
        if prev is None or rec["max_rel_err"] > prev["max_rel_err"]:
            keep = dict(rec)
            if prev is not None:  # keep the timing of the kernel's first mode
                keep["ms"], keep["plain_ms"] = prev["ms"], prev["plain_ms"]
            results[kernel] = keep

    with torch.no_grad():
        n = res * res
        # K1 (down-block prefix / out-head norm), with and without chained stats
        c = ch
        x = rnd(b, n, c, scale=0.8, shift=0.2)
        gamma, beta = fold(c)
        gr = adm_groups(c)
        stats = fn.channel_stats_plain(x)
        check("K1 channel_stats", "(B,N,C)", fn.channel_stats(x), stats,
              lambda: fn.channel_stats(x), lambda: fn.channel_stats_plain(x))
        want = fn.gn_silu_plain(x, gamma, beta, gr)
        # the first mode of each kernel is timed alone (chained stats): its
        # time is the one the summary line reports
        check("K1 gn_silu", "chained stats",
              fn.gn_silu(x, gamma, beta, gr, stats=stats), want,
              lambda: fn.gn_silu(x, gamma, beta, gr, stats=stats),
              lambda: fn.gn_silu_plain(x, gamma, beta, gr))
        check("K1 gn_silu", "own stats pass", fn.gn_silu(x, gamma, beta, gr), want,
              lambda: fn.gn_silu(x, gamma, beta, gr),
              lambda: fn.gn_silu_plain(x, gamma, beta, gr))

        # K2, every mode of the U-Net at its full-resolution shape
        def k2(mode, x, gamma, beta, w, bias, **kw):
            groups = adm_groups(x.shape[-1]) if gamma is not None else 0
            got = fnc.gn_silu_conv(x, gamma, beta, w, bias, groups, **kw)
            plain_kw = {k: v for k, v in kw.items() if k != "stats"}
            want = fnc.gn_silu_conv_plain(x, gamma, beta, w, bias, groups, **plain_kw)
            check("K2 gn_silu_conv", mode, got, want,
                  lambda: fnc.gn_silu_conv(x, gamma, beta, w, bias, groups, **kw),
                  lambda: fnc.gn_silu_conv_plain(x, gamma, beta, w, bias, groups,
                                                 **plain_kw))

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
        k2("act=False (conv_in)", rnd(b, res, res, 4), None, None, conv_w(4, ch),
           bias, emit_stats=True)
        k2("act=False, O=2 (out conv)", h, None, None, conv_w(ch, 2),
           rnd(2, scale=0.3))

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
                                                emit_stats=True))

        # K4 at the 32x32 attention sites: (B * heads, 1024, 64)
        L = (res // 4) ** 2
        q, k, v = (rnd(b, L, 64) for _ in range(3))
        check("K4 attention", "(N, L, D)", fa.attention(q, k, v),
              fa.attention_plain(q, k, v), lambda: fa.attention(q, k, v),
              lambda: fa.attention_plain(q, k, v))
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


def phase_eval(device, hparams, params, b: int) -> dict:
    import torch

    from m_cedm_tpu_torch import kernels
    from m_cedm_tpu_torch.data.masks import eval_masks_var
    from m_cedm_tpu_torch.tasks import build_task

    r = hparams["model"]["resolution"]
    rs = np.random.RandomState(SEED + 3)
    h, tg, xg, u = synthetic_swe_batch(rs, b, r)
    stats = {"input_mean": h.mean(), "input_std": h.std(),
             "target_mean": u.mean(), "target_std": u.std()}
    batch = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                  for a in (h, tg, xg, u))
    mask = torch.from_numpy(eval_masks_var(r, r)["u"]).to(device)

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
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    if launches["K4 attention"] != 4 * calls:
        raise AssertionError(f"K4 launched {launches['K4 attention']} times for "
                             f"{calls} U-Net forwards")

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
    params = phase_forward(device, hparams, BATCH)
    launches = phase_eval(device, hparams, params, BATCH)
    summary = []
    for name, (source, replaces) in KERNEL_INFO.items():
        rec = results[name]
        summary.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": rec["max_abs_err"],
                        "max_rel_err": rec["max_rel_err"], "tol": rec["tol"],
                        "ms": rec["ms"], "plain_ms": rec["plain_ms"]})
    emit({"kernels": summary})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
