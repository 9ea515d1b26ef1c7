"""Time K4 (fp32 or bf16), K6 (fp32 or bf16), K2/K3 (fp32 or bf16), their backward (fp32 or bf16), K5 (fp32 or bf16), K7 (fp32 or bf16), K1's backward (fp32 or bf16), K1's bf16 forward, the bf16 narrow convs or conv_in's bf16 wgrad built from other CUDA sources beside the package's own, on one card.

    python -m m_cedm_tpu_torch.kernels.attention_sources [OTHER.cu ...]
        [--kernel k4|k4bf16|k6|k6bf16|k2|k2bf16|k2bwd|k2bwdbf16|k5|k5bf16|k7|
                  k7bf16|k1bwd|k1bwdbf16|k1bf16|narrowbf16|wgradnarrowbf16]
        [--variant NAME ...]
        [--sass DIR]
    python -m m_cedm_tpu_torch.kernels.attention_sources --kernel mma

Every source exports the C entry points of the kernel's package source with
the same signatures: the package's own source, the files given (say, a
parent commit's csrc file unpacked with `git archive`), and each
`--variant`, the package's source with one named change (VARIANTS), or the
first file given with one (FILE_VARIANTS).

  k4 (the default)  `mc_attention_fwd` and `mc_attention_bwd`
      (csrc/fused_attention.cu), checked at the flagship's attention shape
      (N = 16, L = 1024, D = 64; forward output and the three gradients).
  k4bf16  the bf16 K4 (csrc/fused_attention.cu): `mc_attention_fwd_bf16`
      with and without its fp32 output `o32`, `mc_attention_bwd_bf16`, and
      its dq and dk/dv kernels apart where the source exports them
      (`mc_attention_bwd_dq_bf16`, `mc_attention_bwd_dkdv_bf16`), at N = 16
      (the flagship's attention sites) and N = 80 (the CLI test's folded
      ensemble), L = 1024, D = 64; each output held to the bf16 plain version
      (max and mean error of scale; o32 to the fp32 plain attention), the
      backward to its own bits on a repeat; bf16 SDPA's forward and its
      autograd backward timed beside them. Timed on the card's clock: CUDA
      events around ten calls queued behind a spin kernel that outlasts
      their enqueueing (chip_smoke.py's device_ms), the median of five. Each
      library's SASS is counted per kernel (HGMMA: wgmma; HMMA: mma.sync).
  k6  `mc_apply_dots` (csrc/linear_attention.cu), at the OFormer's two
      shapes (BH = 16 and 64, N = 16,384, D = E = 128).
  k6bf16  the bf16 K6 (csrc/linear_attention.cu) at BH 16 and 64, N 16,384
      and 8,192 (the time prediction), D = E = 128, with an fp32 and a bf16
      factor: a source that exports `mc_apply_dots_bf16_tma` (this
      package's) on that route (TMA ring, producer warp, wgmma, TMA
      stores), one without it (the parent's, unpacked with `git archive`)
      through `mc_apply_dots_bf16`; each output held to the bf16 plain
      version (max and mean error of scale) and to its own bits on a
      repeat; bf16 `torch.bmm` timed beside (with the package's source);
      each source's SASS counts of its apply_dots kernels (HGMMA, HMMA,
      UTMALDG, UTMASTG) and each case's bytes bound; on the card's clock
      (device_ms, the median of five). Variants `k6bf16_*` change the ring
      or the staged outputs, diagnostics `diag_k6bf16_*` leave out the
      products, the stores or the factor's loads.
  k2  `mc_gn_silu_conv` and `mc_gn_silu_up_conv` (csrc/fused_norm_conv.cu),
      at the flagship's shapes (B = 16, ch 64): every K2 mode of
      chip_smoke.py's phase 2 (the identity tail at res 128 with chained
      statistics, with emitted statistics, identity_up, the projection from
      the 128-channel concat, the 128-channel decoder conv0, the linear down
      conv0 at res 64), the identity tail at res 64 and 32, and K3 to res 128.
  k2bf16  `mc_gn_silu_conv_bf16` and `mc_gn_silu_up_conv_bf16` (the bf16
      instances, csrc/fused_norm_conv.cu), called directly at every K2 / K3
      case of chip_smoke.py's phase 15.1 (B = 16, ch 64: the res-128
      identity tail with chained statistics, with emitted statistics,
      identity_up, the projection from the 128-channel concat, the
      128-channel decoder conv0, the linear down conv0 at res 64 with bf16
      conv2d timed beside it, the identity tail at res 64 and 32, K3 to res
      128), each output against the bf16 plain version (max and mean error
      of scale, statistics of theirs); a source that exports
      `mc_gn_silu_conv_bf16_plan` also gives each case's plan (tile rows,
      resident weights, blocks, shared memory, blocks an SM).
  k2bwd  `mc_conv_wgrad` and `mc_conv_dgrad` (csrc/fused_norm_conv_bwd.cu)
      at the flagship train step's shapes (B = 16, ch 64): the res-128
      identity tail (wgrad and dgrad with the activation), the decoder's
      128-channel conv0, the 1x1 projection from the 128-channel concat
      (one-tap wgrad), the down blocks' linear conv0 at res 64, conv_in
      (C = 4, wgrad only) and K3 from res 64 to 128 (wgrad and the
      up-fold dgrad); each kernel called alone, with the reduce of its
      partials. A source that exports `mc_conv_bwd_tiles` takes the
      scratch arguments of this package's (fixed-order partials); one
      without it is called as the earlier CUDA-core kernels were (zeroed
      outputs that it adds into with atomics, 16-channel wgrad slices), so
      an older commit's source is timed through its own interface.
  k2bwdbf16  the bf16 K2 / K3 backward (csrc/fused_norm_conv_bwd.cu:
      `mc_conv_wgrad_bf16`, `mc_conv_dgrad_bf16`, `mc_gn_dx_bf16`) at every
      K2 / K3 case of chip_smoke.py's phase 16.1 (B = 16, ch 64: the res-128
      identity tail with chained statistics, identity_up, the projection
      from the 128-channel concat with its one-tap wgrad, the 128-channel
      decoder conv0, the linear down conv0 at res 64, conv_in's wgrad, K3
      from res 64 to 128), each piece called directly and timed apart:
      wgrad, dgrad (each with its fixed-order reduce), the reduces alone
      (`mc_colsum`, `mc_conv_dgrad_bf16_reduce`), the dx pass, the dx pass as
      the earlier PyTorch passes, and the whole backward, which is held to
      the bf16 plain version and to its own bits on a repeat. A source
      without `mc_conv_bwd_bf16_plan`, such as the parent's unpacked with
      `git archive`, is called through its own interface (wgrad runs an
      image, K3's column-folded ds, dx, the row fold and the low-res tail in
      PyTorch); variants `diag_k2bwdbf16_*` leave out wgrad's activation
      pass, its products or its copies, or dgrad's products or copies.
  k5  `mc_kv_dots` (csrc/linear_attention.cu), at BH = 16 and 64 (N =
      16,384, D = E = 128), with the wrapper's split rule (about one block
      per SM) and with two blocks per SM (the rule of the CUDA-core kernel
      it replaced).
  k5bf16  the bf16 K5 (csrc/linear_attention.cu) at K6bf16's shapes: a
      source that exports `mc_kv_dots_bf16_tma` (this package's) at every
      cluster size 1 to 8, the wrapper's rule (`kv_cluster`, from the
      clusters the card holds at once, which
      `mc_kv_dots_bf16_tma_clusters` reports and the run prints) marked;
      one without it (the parent's) through `mc_kv_dots_bf16` at its split
      rule with its workspace and second launch; each output held to the
      plain version (fp32, of scale) and to its own bits on a repeat; bf16
      `torch.bmm` of k^T and v (bf16 out, context) and the same with
      `out_dtype=torch.float32` (the same function, where the card's torch
      has it) timed beside; SASS counts and bounds as k6bf16. Variant
      `k5bf16_stages_6`, diagnostics
      `diag_k5bf16_no_mma`, `diag_k5bf16_no_sums`, `diag_k5bf16_no_out_stores`,
      `diag_k5bf16_empty`.
  k7  `mc_unet_block` (csrc/fused_block.cu), the whole ADM block, at every
      mode of chip_smoke.py's phase 9 at the flagship's shapes (B = 16, ch
      64: the identity block at res 128 with chained and emitted
      statistics, the decoder's 64 + 64 -> 64 block with its 1x1 projection,
      the up block from res 64 to 128, and the ragged 128 + 128 -> 128 case)
      and the identity block at res 64 and 32, with the input statistics
      given; beside it, once, the two-kernel path (K2 conv0 emitting its
      statistics, then the K2 tail; K3 then K2 for the up block) through the
      package's wrappers on the same inputs, and each case's items and grid.
  k7bf16  `mc_unet_block_bf16` (csrc/fused_block.cu), the bf16 K7, at the
      cases of chip_smoke.py's phase 15.6 (B = 16, ch 64: the identity
      block at res 128, 64 and 32 with chained and emitted statistics, the
      decoder's 64 + 64 -> 64 block with its 1x1 projection emitting
      statistics, the up block from res 64 to 128, and the ragged 128 + 128
      -> 128 case, whose conv0 weights stream), each output held to the bf16
      plain version (max and mean error of scale, the statistics apart) and
      to its own bits on a repeat, each case's plan (weights resident by
      phase, shared memory, blocks) from `mc_unet_block_bf16_plan`; beside
      it, once, the bf16 two-kernel path (K2 conv0 emitting its statistics,
      then the K2 tail; K3 then K2 for the up block) through the package's
      wrappers on the same inputs; on the card's clock (device_ms, the
      median of five).

  k1bwd  `mc_gn_silu_bwd` (csrc/fused_norm.cu), K1's backward, at the
      flagship train step's shapes (B = 16, C = 64, 16 groups, N = 128^2
      and 64^2), each output against float64 and for the same bits on a
      repeat; the bound and the slab plan of each case, and for a source of
      this package's interface (it exports `mc_gn_silu_bwd_occupancy`) its
      ring stages, shared memory and co-resident blocks. A source without
      it, such as the parent's two-pass kernels, is called through its own
      interface (zeroed dgamma / dbeta it adds into with atomics).
      csrc/variants/k1_bwd_l2_chunks.cu, given as a file, is the two-pass
      alternative launched per chunk of samples that fits in L2.

  k1bwdbf16  K1's bf16 backward `mc_gn_silu_bwd_bf16` (csrc/fused_norm.cu,
      gn_silu_bwd_cluster_kernel, its plan csrc/k1_bwd_plan.h) called
      directly at the train step's shapes (B 16, C 64, 16 groups, N 128^2
      and 64^2) and the CLI's batch 32 at res 128: dx held to the bf16 plain
      version (max and mean of scale), dgamma and dbeta to it and to float64,
      every output to its own bits on a repeat, each case's plan and bound,
      the call as the wrapper makes it (outputs allocated inside the timed
      call) on the card's clock (device_ms, the median of five) and by the
      host's (`host_us`). A source without `mc_gn_silu_bwd_bf16_plan`, such
      as the parent's, is called through its own interface (the per-slab
      scratch and zeroed counters of kernels/fused_norm.py::bwd_plan's
      slabs). Variants `k1bwdbf16_*` change one constant of the plan or
      the copies' L2 policy; the diagnostics `diag_k1bwdbf16_*` leave out
      the exchange between a sample's clusters, the wait for the cluster's
      partials, the copies, the SiLU gradient, a pass's arithmetic or the
      stores. `python3 -m m_cedm_tpu_torch.kernels.k1bwdbf16_trace` times
      its phases block by block.

  wgradnarrowbf16  conv_in's bf16 wgrad (`mc_conv_wgrad_bf16` at C <= 8,
      linear, with dbias; csrc/fused_norm_conv_bwd.cu) called directly at
      the flagship's C 4 -> 64 and adm_edm_cond_h's C 2 -> 64 (B 16, res
      128) and at ragged shapes, with the scratch rows of each source's own
      plan (`mc_conv_bwd_bf16_plan`, the same interface in the parent's
      source): dW and dbias held to float64 and to their bits on a repeat,
      timed with their reduce on the card's clock and by the host's
      (`host_us`), bf16 `torch.ops.aten.convolution_backward` of the weight
      and bias gradients alone (output_mask [False, True, True]) on the same
      inputs beside, each library's SASS counts (HGMMA, FFMA). Variants
      `wgradnarrowbf16_*` change the ring's depth; the diagnostics
      `diag_wgradnarrowbf16_*` leave out the products, the g copies, the
      im2col tile or the reduce.

  k1bf16  K1's forward passes (csrc/fused_norm.cu) called directly:
      `mc_channel_stats_bf16` at the main path's 32x32 sites, (16, 1024, 64)
      and (16, 1024, 128), and at the CLI test's batch 80, then at res 128
      (16, 16384, 64) as context; `mc_gn_silu_bf16`
      with chained statistics at its sites, (16, 16384, 64) (the down
      blocks' norm0 at res 128 and out_norm) and (16, 4096, 64) (norm0 at res
      64); beside them the fp32 instances, `mc_channel_stats` at the two
      32x32 shapes and res 128 and `mc_gn_silu` at (16, 16384, 64). Variants
      `k1bf16_*` change one constant of the plans or the apply's stores.
      Each output is held
      to the plain version (bf16: max and mean error of scale; statistics
      max error of scale) and the statistics to their own bits on a repeat;
      beside each apply case, `Tensor.copy_` of x into y (the same bytes);
      timed on the card's clock (device_ms, the median of five). A source
      without `mc_channel_stats_plan`, such as the parent's unpacked with
      `git archive`, is called through its own interface (zeroed sums it
      adds into with atomics, zeroed inside the timed call as its wrapper
      allocated them); for this package's the plan of each case
      (`mc_channel_stats_plan`, `mc_gn_silu_plan`) is printed.

  narrowbf16  the bf16 narrow convs (csrc/narrow_conv.cu) called directly:
      `mc_narrow_conv_bf16` at the flagship's conv_in (C 4 -> O 64, with
      and without its statistics) and out conv (C 64 -> O 2), at
      adm_edm_cond_h's (C 2 -> 64 with statistics; C 64 -> O 1) and at batch
      80 (B 16 otherwise, res 128), and `mc_narrow_conv_bwd_bf16` (the out
      conv's backward) with and without dx, the dgrad instance being the
      difference; each output held to the bf16 plain version (max and mean
      error of scale, the statistics apart) and to its own bits on a repeat;
      the fp32 instances (`mc_narrow_conv`) and bf16 conv2d timed beside the
      flagship's two; on the card's clock (device_ms, the median of five).
      Variants `narrowbf16_*` change one constant of the new kernels;
      `diag_parent_*` change the parent's CUDA-core kernels given as the
      first file (without their weight restaging, products, x staging or
      stores, or with one 8-byte bf16 store a pixel).

  mma  no source: the rate of TF32 mma.sync.m16n8k8 with fp32 accumulation
      on this card, from a kernel that issues nothing else (eight
      independent accumulators a warp, 4 to 32 warps an SM), as the
      ceiling of the 3xTF32 kernels built on it; and the rate of the
      3xTF32 split itself (two cvt.rn.tf32.f32 and a subtraction), in
      warp-wide splits per ns per SM; then the rate of bf16
      mma.sync.m16n8k16 with fp32 accumulation, the same way, the ceiling
      of the bf16 kernels (K2/K3's gnsc_bf16_kernel) beside the 989
      TFLOP/s of bf16 wgmma.

Each output is checked against float64 (the plain versions, or einsum, in
float64 on the card): errors are max |err| / max(1, max |float64|), the
largest over a call's outputs. All sources are built at once with the
package's nvcc flags and timed with CUDA events: the kernels called directly
(no autograd; K2's emitted-statistics buffers are zeroed inside the timed
call, as the wrapper allocates them zeroed), the median of 10 runs of 10
back-to-back calls, every source in turn, in two rounds of opposite order.
One JSON line per source and round, after the card's nvidia-smi name and
power limit. `--sass DIR` writes each library's SASS (cuobjdump) to DIR.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from m_cedm_tpu_torch.kernels import _build
from m_cedm_tpu_torch.kernels._timing import device_ms

# the bf16 K7's plan with 8 x 16 tiles everywhere (csrc/k7_plan.h's text and
# its replacement)
K7_TILES_8 = ("const bool big = tiles16 * nch >= (long long)kBigTileWaves * sms &&",
              "const bool big = false &&")

# name -> (kernel, text in its package source, the replacement[, the csrc
# header that holds the text instead])
VARIANTS = {
    # the split rounded with cvt.rna (ties away), which ptxas expands on sm_90
    "cvt_rna": ("k4", 'asm("cvt.rn.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n  return r;',
                'asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n'
                '  return r & 0xffffe000u;'),
    # lo left as the exact fp32 difference x - hi, which the tensor core reads
    # as TF32 (truncating it): one conversion a split instead of two
    "lo_unrounded": ("k4", "  lo = to_tf32(x - __uint_as_float(hi));",
                     "  lo = __float_as_uint(x - __uint_as_float(hi));"),
    # one TF32 product (hi * hi) instead of three; the lo halves go unused
    "one_product": ("k4", "  mma_tf32(c, a.lo, bh0, bh1);\n  mma_tf32(c, a.hi, bl0, bl1);\n",
                    ""),
    # the bf16 K4 with P and dS in two bf16 pieces (hi, mid), not three: the
    # lo products left out
    "k4bf16_two_pieces": ("k4bf16", "  product_piece(d, lo, b_tile);\n", ""),
    # the bf16 K4 forward at two blocks an SM (255 registers) whatever the
    # grid, or at three (168) whatever the grid
    "k4bf16_fwd_2_blocks": ("k4bf16", "  if ((long)grid.x * grid.y > 2L * bf16t::sm_count())\n",
                            "  if (false)\n"),
    "k4bf16_fwd_3_blocks": ("k4bf16", "  if ((long)grid.x * grid.y > 2L * bf16t::sm_count())\n",
                            "  if (true)\n"),
    # diagnostics, not kernels: the bf16 K4 forward without its P V products
    # (and so without P's split), or with P packed once instead of split in
    # three (results wrong; the time of the rest)
    "diag_k4bf16_fwd_no_pv": (
        "k4bf16",
        "    product_split(acc, pl, pm, ph, sv + (j % kHFwdStages) * kHTile);  // acc += P_j V_j\n",
        ""),
    "diag_k4bf16_fwd_no_split": (
        "k4bf16", "    split_acc(s, ph, pm, pl);\n",
        "#pragma unroll\n    for (int i = 0; i < 16; ++i)\n"
        "      ph[i] = pm[i] = pl[i] = bf16t::pack2(s[2 * i], s[2 * i + 1]);\n"),
    # K6's tensor-core partial sums added into the fp32 accumulator after four
    # k-steps, or once (the products accumulated on the tensor cores alone)
    "temp_steps_4": ("k6", "constexpr int kTempSteps = 1;", "constexpr int kTempSteps = 4;"),
    "temp_steps_16": ("k6", "constexpr int kTempSteps = 1;", "constexpr int kTempSteps = 16;"),
    # K6 with one m16 tile a warp: 16 warps a block instead of 8
    "m_tiles_1": ("k6", "constexpr int kMTiles = 2;", "constexpr int kMTiles = 1;"),
    # K2/K3's partial sums added into the fp32 accumulator after each tap
    # instead of after a chunk's nine
    "k2_temp_steps_1": ("k2", "constexpr int kTempSteps = 9;", "constexpr int kTempSteps = 1;"),
    # diagnostics, not kernels: K2 with its products left out, or its
    # staging pass (results wrong; the time of the rest)
    "diag_k2_no_mma": ("k2", "      mma_chunk<9>(sa, sb, acc, rg, cq, lane);", "      ;"),
    "diag_k2_no_split": ("k2", "      split_x<kUp>(p, rx + st * kRawX, sa, q * kCK, ty0, tx0, s_a, s_b, tid);\n      split_w<9>(rw + st * kRawW, sb, tid);", "      ;"),
    # the bf16 K2/K3 with 16 x 16 tiles only where they give two tiles a
    # block (not at res 64, B = 16), or with 8 x 16 tiles everywhere
    "k2bf16_big_tile_waves_2": ("k2bf16", "constexpr int kBigTileWaves = 1;",
                                "constexpr int kBigTileWaves = 2;"),
    "k2bf16_small_tiles": ("k2bf16", "constexpr int kBigTileWaves = 1;",
                           "constexpr int kBigTileWaves = 1 << 20;"),
    # diagnostics, not kernels: the bf16 K2/K3 with its products left out, or
    # its activation pass (results wrong; the time of the rest)
    "diag_k2bf16_no_mma": (
        "k2bf16",
        "    if (q < p.nc)\n"
        "      mma_chunk_bf16<kUp, 9>(bf16t::smem_addr(A), wbase, acc, warp, lane);\n"
        "    else\n"
        "      mma_chunk_bf16<kUp, 1>(bf16t::smem_addr(A), wbase, acc, warp, lane);\n",
        "    (void)wbase;\n"),
    "diag_k2bf16_no_act": (
        "k2bf16",
        "    if (q < p.nc && p.act) activate_h<kUp, kTHt>(p, A, ty0, tx0, q, s_sc, s_sh, tid);\n",
        ""),
    # ... with the activation's SiLU left out (the GroupNorm affine only),
    # with no copies after the first step's, or with no output stores
    "diag_k2bf16_no_silu": (
        "k2bf16",
        "      o[i] = bf16t::pack2(bf16t::silu_fast(lo * sc[2 * i] + sh[2 * i]),\n"
        "                          bf16t::silu_fast(hi * sc[2 * i + 1] + sh[2 * i + 1]));\n",
        "      o[i] = bf16t::pack2(lo * sc[2 * i] + sh[2 * i], hi * sc[2 * i + 1] + sh[2 * i + 1]);\n"),
    "diag_k2bf16_no_copies": (
        "k2bf16",
        "      load_step_h<kUp, kTHt>(p, stage0 + (st ^ 1) * p.stage_bytes, sm + (st ^ 1) * w_slot,\n"
        "                             b1, ty1, tx1, (s + 1) % p.nq, o0, tid);\n",
        "      (void)b1;\n"),
    "diag_k2bf16_no_stores": ("k2bf16", "        *reinterpret_cast<uint4*>(dst) = v;\n",
                              "        (void)dst;\n"),
    # the K2 / K3 backward: dgrad's partial sums added after each tap instead
    # of after a chunk's nine; wgrad's after each k-step instead of a tile's
    # eight
    "k2bwd_temp_steps_1": ("k2bwd", "constexpr int kTempSteps = 9;",
                           "constexpr int kTempSteps = 1;"),
    "k2bwd_wtemp_steps_1": ("k2bwd", "constexpr int kWTempSteps = 8;",
                            "constexpr int kWTempSteps = 1;"),
    # diagnostics, not kernels: the backward with its products left out, or
    # its split passes (results wrong; the time of the rest)
    "diag_k2bwd_no_mma": ("k2bwd", "        wg_mma_step(pa, pb, part, s, dy, dx, lane);\n", ""),
    "diag_k2bwd_no_split": ("k2bwd", "    wg_split<kUp>(p, rx, rgt, pa, pb, s_a, s_b, ty0, tx0, c0, tid, gsum);\n",
                            ""),
    "diag_k2bwd_dgrad_no_mma": ("k2bwd", "    dg_mma_chunk(sa, sb, acc, rg_, cq, lane);\n", ""),
    # wgrad without waiting for its copies (a race; the time without the
    # exposed copy latency)
    "diag_k2bwd_no_copy_wait": ("k2bwd", "    cp_wait<0>();\n    __syncthreads();  // the tile has landed",
                                "    __syncthreads();  // the tile has landed"),
    # diagnostics of the bf16 K2/K3 backward (results wrong; the time of the
    # rest): wgrad without its activation pass, its products or its copies of
    # the next tile; dgrad without its products or its copies of the next step
    "diag_k2bwdbf16_no_act": (
        "k2bwdbf16",
        "    if (p.act) wg_activate<kUp, kTHt>(p, X, ty0, tx0, s_sc, s_sh, c0, tid);\n", ""),
    "diag_k2bwdbf16_wgrad_no_mma": (
        "k2bwdbf16", "      bf16t::wg_mma(acc[dx], a[dx], desc);\n", ""),
    "diag_k2bwdbf16_wgrad_no_copies": (
        "k2bwdbf16",
        "      wg_load_tile_h<kUp, kTHt>(p, sm + (st ^ 1) * p.g_bytes, sm + p.x_off + (st ^ 1) * p.x_bytes,\n"
        "                                b1, ty1, tx1, c0, o0, tid);\n", ""),
    "diag_k2bwdbf16_dgrad_no_mma": (
        "k2bwdbf16",
        "      bf16t::wg_mma_kb(acc, a[kk & 1], desc + 2 * kk);  // + 32 bytes a k16 step\n", ""),
    "diag_k2bwdbf16_dgrad_no_copies": (
        "k2bwdbf16",
        "      dg_load_a<kTHt>(p, stage0 + (st ^ 1) * p.stage_bytes, b1, ty1, tx1, q1, tid);\n",
        ""),
    # K5's partial sums added after each k-step instead of after a 64-row stage
    "k5_temp_steps_1": ("k5", "constexpr int kKvTempSteps = 8;",
                        "constexpr int kKvTempSteps = 1;"),
    # the bf16 K5 on TMA with a ring of six stages, not four
    "k5bf16_stages_6": ("k5bf16", "constexpr int kKvTmaStages = 4;",
                        "constexpr int kKvTmaStages = 6;"),
    # diagnostics, not kernels: the bf16 K5 on TMA without its products
    "diag_k5bf16_no_mma": ("k5bf16", "bf16t::wg_mma_ss<1, 1>(",
                           "if (false) bf16t::wg_mma_ss<1, 1>("),
    # the bf16 K6 on TMA with a ring of three stages, or one staged output
    # tile a warpgroup (each tile's stores read before the next is staged)
    "k6bf16_out_bufs_1": ("k6bf16", "constexpr int kOutBufs = 2;",
                          "constexpr int kOutBufs = 1;"),
    # diagnostics, not kernels: the bf16 K6 on TMA without its products, its
    # stores or its factor's loads
    "diag_k6bf16_no_mma": ("k6bf16", "bf16t::wg_mma_ss<0, 1>(acc[pe], da,",
                           "if (false) bf16t::wg_mma_ss<0, 1>(acc[pe], da,"),
    "diag_k6bf16_no_stores": ("k6bf16", "tma::store_3d(&omap,",
                              "if (false) tma::store_3d(&omap,"),
    "diag_k6bf16_no_factor": ("k6bf16", "      fl.store(fac, D, E, tid);",
                              "      if (false) fl.store(fac, D, E, tid);"),
    "k6bf16_stages_3": ("k6bf16", "constexpr int kApTmaStages = 4;",
                        "constexpr int kApTmaStages = 3;"),
    # diagnostics, not kernels: the bf16 K5 on TMA without the loads, sums
    # and stores of its cluster reduce, or with no
    # stage (launch, prologue and reduce alone)
    "diag_k5bf16_no_sums": ("k5bf16", "  const int q4 = (d1 - d0) * E / 4;",
                            "  const int q4 = 0;"),
    "diag_k5bf16_no_out_stores": (
        "k5bf16", "    *reinterpret_cast<float4*>(out + ((size_t)bh * D + d) * E + e) = sum;",
        "    if (sum.x == -1.5e-38f) out[0] = sum.y;"),
    "diag_k5bf16_empty": ("k5bf16",
                          "  const int stages = n1 > n0 ? (n1 - n0 + kKvTmaRows - 1) / kKvTmaRows : 0;",
                          "  const int stages = 0;"),
    # K1's backward with one stage kept free for the copies ahead, not two
    # (pass B trailing by two samples where the ring holds three, at res 128)
    "k1bwd_min_lead_1": ("k1bwd", "constexpr int kBwdMinLead = 2;",
                         "constexpr int kBwdMinLead = 1;"),
    # ... with three, five or six stages at least, not four (at res 128 three
    # hold whole slabs; with more, a slab's last rows come from device
    # memory in both passes)
    "k1bwd_min_stages_3": ("k1bwd", "constexpr int kBwdMinStages = 4;",
                           "constexpr int kBwdMinStages = 3;"),
    "k1bwd_min_stages_5": ("k1bwd", "constexpr int kBwdMinStages = 4;",
                           "constexpr int kBwdMinStages = 5;"),
    "k1bwd_min_stages_6": ("k1bwd", "constexpr int kBwdMinStages = 4;",
                           "constexpr int kBwdMinStages = 6;"),
    # ... with a group's finish keeping 16 loads of 16 bytes in flight a lane,
    # not 8
    # K1's forward: the apply's 16-byte stores as plain (write-back) stores;
    # 4 or 8 copies in flight a thread, not 6; the statistics pass on
    # clusters of 4 blocks at most, or of 8 down to 128 rows a block (8 at
    # the 32x32 sites)
    "k1bf16_plain_stores": ("k1bf16",
                            "    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));",
                            "    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);"),
    "k1bf16_apply_stages_4": ("k1bf16", "constexpr int kApplyStages = 6;",
                              "constexpr int kApplyStages = 4;"),
    "k1bf16_apply_stages_8": ("k1bf16", "constexpr int kApplyStages = 6;",
                              "constexpr int kApplyStages = 8;"),
    "k1bf16_cluster_4": ("k1bf16", "constexpr int kStatsCluster = 8;",
                         "constexpr int kStatsCluster = 4;"),
    "k1bf16_min_rows_128": ("k1bf16", "constexpr int kStatsMinRows = 256;",
                            "constexpr int kStatsMinRows = 128;"),
    # a diagnostic, not a kernel: the apply without its SiLU (y = x a + b)
    "diag_k1bf16_no_silu": ("k1bf16", "      for (int v = 0; v < V; ++v) y[v] = silu<T>(y[v] * a[v] + sh[v]);",
                            "      for (int v = 0; v < V; ++v) y[v] = y[v] * a[v] + sh[v];"),
    "k1bwd_finish_batch_16": ("k1bwd", "constexpr int kBatch = U == 4 ? 8 : 16;",
                              "constexpr int kBatch = 16;"),
    # K1's bf16 backward (its plan in csrc/k1_bwd_plan.h): the layouts a
    # sample's blocks take: every block a cluster of its own (the hand-off
    # through device memory alone); clusters of 4, two a sample in two waves;
    # one cluster of 8 a sample at two blocks an SM (half the shared memory,
    # 16 KB chunks, so that the ring keeps two slots a group);
    # 16 or 12 compute warps where 8 hold a row (C <= 1024), not 8;
    # chunks of 16 KB, not 32; pass A's copies of
    # the rows read again evict-last or evict-first, not at normal priority
    "k1bwdbf16_cluster_1": ("k1bwdbf16", "constexpr int kMaxCluster = 8;",
                            "constexpr int kMaxCluster = 1;", "k1_bwd_plan.h"),
    "k1bwdbf16_cluster_4_two_waves": (
        "k1bwdbf16",
        "constexpr int kMaxCluster = 8;             // the portable cluster size\n"
        "constexpr int kOneWave = 1;",
        "constexpr int kMaxCluster = 4;\nconstexpr int kOneWave = 0;", "k1_bwd_plan.h"),
    "k1bwdbf16_two_per_sm": (
        "k1bwdbf16",
        "constexpr int kChunkBytes = 32768;         // x and g of a chunk of rows (at least one row)\n"
        "constexpr int kBlocksPerSm = 1;",
        "constexpr int kChunkBytes = 16384;\nconstexpr int kBlocksPerSm = 2;", "k1_bwd_plan.h"),
    "k1bwdbf16_consumers_512": ("k1bwdbf16", "constexpr int kNarrowConsumers = 256;",
                                "constexpr int kNarrowConsumers = 512;", "k1_bwd_plan.h"),
    "k1bwdbf16_chunk_16k": ("k1bwdbf16", "constexpr int kChunkBytes = 32768;",
                            "constexpr int kChunkBytes = 16384;", "k1_bwd_plan.h"),
    "k1bwdbf16_groups_1": ("k1bwdbf16", "constexpr int kGroups = 2;",
                           "constexpr int kGroups = 1;", "k1_bwd_plan.h"),
    "k1bwdbf16_consumers_384": ("k1bwdbf16", "constexpr int kNarrowConsumers = 256;",
                                "constexpr int kNarrowConsumers = 384;", "k1_bwd_plan.h"),
    "k1bwdbf16_keep_last": (
        "k1bwdbf16",
        "const uint64_t keep = tma::policy_evict_normal(), once = tma::policy_evict_first();",
        "const uint64_t keep = tma::policy_evict_last(), once = tma::policy_evict_first();"),
    "k1bwdbf16_no_keep": (
        "k1bwdbf16",
        "const uint64_t keep = tma::policy_evict_normal(), once = tma::policy_evict_first();",
        "const uint64_t keep = tma::policy_evict_first(), once = keep;"),
    # diagnostics, not kernels (results wrong): no hand-off between the
    # clusters of a sample; no wait for the cluster's partials; no copies
    # (the barriers complete on arrival alone); no SiLU gradient in either
    # pass; no dx stores
    "diag_k1bwdbf16_no_xchg": ("k1bwdbf16", "    if (pl.clusters > 1) {\n      // a sample",
                               "    if (pl.clusters < 0) {\n      // a sample"),
    "diag_k1bwdbf16_no_cluster_wait": ("k1bwdbf16", "    tma::mbar_wait_cluster(ready, it & 1);\n",
                                       ""),
    "diag_k1bwdbf16_no_copies": (
        "k1bwdbf16",
        "          tma::mbar_expect_tx(full + s, 2 * bytes);\n",
        "          tma::mbar_arrive(full + s);\n          if (bytes) return;\n"),
    "diag_k1bwdbf16_no_silu": (
        "k1bwdbf16",
        "  asm(\"rcp.approx.ftz.f32 %0, %1;\" : \"=f\"(sig) : \"f\"(1.f + e));\n"
        "  return gv * sig * (1.f + y * (1.f - sig));",
        "  sig = e;\n  return gv * y + 0.f * sig;"),
    "diag_k1bwdbf16_no_pass_a_math": (
        "k1bwdbf16",
        "      if (active) {\n        for (int r = slot; r < nr; r += rs) {\n          float xv[kV], gv[kV];\n",
        "      if (!active) {\n        for (int r = slot; r < nr; r += rs) {\n          float xv[kV], gv[kV];\n"),
    "diag_k1bwdbf16_no_pass_b_math": (
        "k1bwdbf16",
        "      if (active) {\n        for (int r = slot; r < nr; r += rs) {\n          float xv[kV], gv[kV], d[kV];\n",
        "      if (!active) {\n        for (int r = slot; r < nr; r += rs) {\n          float xv[kV], gv[kV], d[kV];\n"),
    "diag_k1bwdbf16_no_stores": (
        "k1bwdbf16", "        tma::bulk_store(dxb + (size_t)q * cr * c, data + (size_t)s * pl.slot_bytes,\n"
        "                        2 * nr * c, once);",
        "        if (nr < 0) tma::bulk_store(dxb, data, 2 * nr * c, once);"),
    # conv_in's bf16 wgrad: 2 or 6 ring stages, not 4; diagnostics (results
    # wrong): no products, no g copies (the barriers complete on arrival
    # alone), no im2col tile built, no fixed-order reduce after the kernel
    "wgradnarrowbf16_stages_2": ("wgradnarrowbf16", "constexpr int kNbStages = 4;",
                                 "constexpr int kNbStages = 2;"),
    "wgradnarrowbf16_stages_6": ("wgradnarrowbf16", "constexpr int kNbStages = 4;",
                                 "constexpr int kNbStages = 6;"),
    "diag_wgradnarrowbf16_no_mma": ("wgradnarrowbf16",
                                    "      for (int ks = 0; ks < kNbPix / 16; ++ks)",
                                    "      for (int ks = 0; ks < 0; ++ks)"),
    "diag_wgradnarrowbf16_no_copies": (
        "wgradnarrowbf16",
        "          tma::mbar_expect_tx(full + s, kNbPanel);\n          tma::load_4d(gs, &gmap, full + s, o0, x0, y0, b);",
        "          tma::mbar_arrive(full + s);"),
    "diag_wgradnarrowbf16_no_im2col": (
        "wgradnarrowbf16",
        "        for (int mp = 0; mp < kMP; ++mp)\n#pragma unroll\n          for (int jj = 0; jj < 8; ++jj) {\n            uint32_t w[4];\n#pragma unroll\n            for (int e2 = 0; e2 < 4; ++e2) {\n              const int m",
        "        for (int mp = 0; mp < 0; ++mp)\n#pragma unroll\n          for (int jj = 0; jj < 8; ++jj) {\n            uint32_t w[4];\n#pragma unroll\n            for (int e2 = 0; e2 < 4; ++e2) {\n              const int m"),
    "diag_wgradnarrowbf16_no_reduce": (
        "wgradnarrowbf16",
        "  if (err != cudaSuccess) return (int)err;\n  colsum_kernel<<<dim3((unsigned)((k + 31) / 32), 1), 32 * kSumGroups, 0, s>>>(part, dwb, rows,\n                                                                             (int)k);\n  return (int)cudaGetLastError();\n}\n\n// mc_conv_wgrad_bf16",
        "  if (err != cudaSuccess) return (int)err;\n  return (int)cudaGetLastError();\n}\n\n// mc_conv_wgrad_bf16"),
    # K7's partial sums added into the fp32 accumulator after each tap
    "k7_temp_steps_1": ("k7", "constexpr int kTempSteps = 9;", "constexpr int kTempSteps = 1;"),
    # the bf16 K7's TMA route, its plan in csrc/k7_plan.h: 8 x 16 tiles
    # everywhere; four consumer warpgroups of one accumulator at 16 x 16
    # tiles (against two of two)
    "k7bf16_tiles_8": ("k7bf16", *K7_TILES_8, "k7_plan.h"),
    "k7bf16_wg_4": ("k7bf16", "constexpr int kWideWG = 2;", "constexpr int kWideWG = 4;",
                    "k7_plan.h"),
    # the activation's SiLU on bf16t::silu_fast (MUFU with subnormal fix-ups)
    "k7bf16_act_no_ftz": ("k7bf16", "        o[i] = bf16t::pack2(silu_ftz(lo * sc[2 * i] + sf[2 * i]),\n"
                          "                            silu_ftz(hi * sc[2 * i + 1] + sf[2 * i + 1]));",
                          "        o[i] = bf16t::pack2(bf16t::silu_fast(lo * sc[2 * i] + sf[2 * i]),\n"
                          "                            bf16t::silu_fast(hi * sc[2 * i + 1] + sf[2 * i + 1]));"),
    # the activation four positions a pass (against two), or one
    "k7bf16_act_items_4": ("k7bf16", "constexpr int kActItems = 2;", "constexpr int kActItems = 4;"),
    "k7bf16_act_items_1": ("k7bf16", "constexpr int kActItems = 2;", "constexpr int kActItems = 1;"),
    # diagnostics, not kernels: the TMA route without its products, its
    # activation, its TMA stores or its A stages' TMA copies (results wrong;
    # the time of the rest)
    "diag_k7bf16_no_mma": ("k7bf16", "    if (kPhase == 1 && q >= nch)\n      mma_chunk_t<1, kUp",
                           "    if (true) {\n      hook();\n      __syncwarp();\n    } else if (kPhase == 1 && q >= nch)\n      mma_chunk_t<1, kUp"),
    "diag_k7bf16_no_act": ("k7bf16", "    if (ch.taps == 9) {\n      if (ch.lo)\n        activate_t",
                           "    if (false) {\n      if (ch.lo)\n        activate_t"),
    "diag_k7bf16_no_stores": ("k7bf16", "      if (y0 < H) tma::store_4d(dst_map, S_w, o0, tx0, y0, b);",
                              "      ;"),
    "diag_k7bf16_no_loads": ("k7bf16", "(ch.lo ? lowpos_h(kM) : pos_h(kM)) * kPixRow + wbytes);\n    if (ch.lo)",
                             "wbytes);\n    if (true) {\n    } else if (ch.lo)"),
    # diagnostics, not kernels: K7 with the 3x3 products of both phases left
    # out, or their staging pass (results wrong; the time of the rest)
    "diag_k7_no_mma": ("k7", "      mma_chunk<9>(sa, sb, acc, rg, cq, lane);", "      ;"),
    "diag_k7_no_split": ("k7", "      split_x<kPhase == 0 && kUp>(rx + st * kRawX, sa, q * kCK, C, H, W, it, s_a, s_b, tid);\n      split_w<9>(rw + st * kRawW, sb, tid);", "      ;"),
    # the bf16 narrow convs: the out conv's ring depth and blocks an SM
    # (two stages leave room for three blocks), conv_in's blocks an SM, and
    # streaming stores (st.global.cs) for either
    "narrowbf16_o_stages_2_blocks_3": (
        "narrowbf16",
        "constexpr int kBOStages = 3;                            // ring depth\n"
        "constexpr int kBOThreads = 128;                         // 2 x 2 warps of 8 x 16 pixels\n"
        "constexpr int kBOBlocksPerSm = 2;",
        "constexpr int kBOStages = 2;                            // ring depth\n"
        "constexpr int kBOThreads = 128;                         // 2 x 2 warps of 8 x 16 pixels\n"
        "constexpr int kBOBlocksPerSm = 3;"),
    "narrowbf16_o_blocks_3": ("narrowbf16", "constexpr int kBOBlocksPerSm = 2;",
                              "constexpr int kBOBlocksPerSm = 3;"),
    "narrowbf16_o_stages_4": ("narrowbf16", "constexpr int kBOStages = 3;",
                              "constexpr int kBOStages = 4;"),
    "narrowbf16_c_blocks_3": ("narrowbf16", "constexpr int kBCBlocksPerSm = 4;",
                              "constexpr int kBCBlocksPerSm = 3;"),
    "narrowbf16_c_threads_256_blocks_2": (
        "narrowbf16", "constexpr int kBCThreads = 128;        // 4 warps: tile rows w and w + 4\nconstexpr int kBCWarps = kBCThreads / 32;\nconstexpr int kBCBlocksPerSm = 4;",
        "constexpr int kBCThreads = 256;        // 4 warps: tile rows w and w + 4\nconstexpr int kBCWarps = kBCThreads / 32;\nconstexpr int kBCBlocksPerSm = 2;"),
    "narrowbf16_c_stream_stores": (
        "narrowbf16", "            *reinterpret_cast<uint4*>(dst) =\n                make_uint4(bf16t::pack2(v[0], v[1]), bf16t::pack2(v[2], v[3]),\n                           bf16t::pack2(v[4], v[5]), bf16t::pack2(v[6], v[7]));",
        "            __stcs(reinterpret_cast<uint4*>(dst),\n                make_uint4(bf16t::pack2(v[0], v[1]), bf16t::pack2(v[2], v[3]),\n                           bf16t::pack2(v[4], v[5]), bf16t::pack2(v[6], v[7])));"),
    # the out conv's 16-byte copies asking L2 for whole 128- or 256-byte
    # lines (each stage reads 32 of a pixel's 128 bytes)
    "narrowbf16_o_l2_128": (
        "narrowbf16",
        "        bf16t::cp16(bf16t::smem_addr(dst + pix * 32 + 16 * (h ^ ((pix >> 2) & 1))),\n                    ok ? xb + ((size_t)y * W + x) * C + c : p.x, ok);",
        "        asm volatile(\"cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\" :: \"r\"(bf16t::smem_addr(dst + pix * 32 + 16 * (h ^ ((pix >> 2) & 1)))), \"l\"(ok ? xb + ((size_t)y * W + x) * C + c : p.x), \"r\"(ok ? 16 : 0) : \"memory\");"),
    "narrowbf16_o_l2_256": (
        "narrowbf16",
        "        bf16t::cp16(bf16t::smem_addr(dst + pix * 32 + 16 * (h ^ ((pix >> 2) & 1))),\n                    ok ? xb + ((size_t)y * W + x) * C + c : p.x, ok);",
        "        asm volatile(\"cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\" :: \"r\"(bf16t::smem_addr(dst + pix * 32 + 16 * (h ^ ((pix >> 2) & 1)))), \"l\"(ok ? xb + ((size_t)y * W + x) * C + c : p.x), \"r\"(ok ? 16 : 0) : \"memory\");"),
    "narrowbf16_o_stream_stores": (
        "narrowbf16", "          *reinterpret_cast<uint4*>(ob + ((size_t)(ty0 + ry) * W + tx0) * O + 8 * j) =\n              *reinterpret_cast<const uint4*>(s_o + ry * kBOTW * O + 8 * j);",
        "          __stcs(reinterpret_cast<uint4*>(ob + ((size_t)(ty0 + ry) * W + tx0) * O + 8 * j),\n              *reinterpret_cast<const uint4*>(s_o + ry * kBOTW * O + 8 * j));"),
    # diagnostics, not kernels: the bf16 narrow convs without their products
    # (results wrong; the time of the rest)
    "diag_narrowbf16_c_no_mma": (
        "narrowbf16", "        for (int j = 0; j < 8; ++j) mma16816(acc[j], a, bw[s][j][0], bw[s][j][1]);",
        "        ;"),
    "diag_narrowbf16_o_no_mma": (
        "narrowbf16", "        if (kFold) {\n          mma16816(acc[r], a, bfr[0].x, bfr[0].y);\n        } else {\n#pragma unroll\n          for (int dy = 0; dy < 3; ++dy)\n            if (r - dy >= 0 && r - dy < 8) mma16816(acc[r - dy], a, bfr[dy].x, bfr[dy].y);\n        }",
        "        ;"),
    # conv_in without a lane's bias, statistics and stores, or without its
    # tiles (the weights' prologue and, with statistics, the finish); the out
    # conv without its tiles, or without its copies
    "diag_narrowbf16_c_no_stores": ("narrowbf16", "        if (x < W) {\n", "        if (x < 0) {\n"),
    "diag_narrowbf16_c_no_tiles": (
        "narrowbf16", "  const int items = p.B * p.tiles;\n\n  // the halo'd tile",
        "  const int items = 0;\n\n  // the halo'd tile"),
    "diag_narrowbf16_c_no_wload": ("narrowbf16", "  if (!kFlip) {\n    if (p.wvec) {  // O % 8 == 0",
                                   "  if (!kFlip && p.B) {\n  } else if (!kFlip) {\n    if (p.wvec) {  // O % 8 == 0"),
    "diag_narrowbf16_c_no_finish": ("narrowbf16", "  if (p.ostats) {\n    // a cooperative launch",
                                    "  if (!p.B) {\n    // a cooperative launch"),
    "diag_narrowbf16_c_empty": ("narrowbf16", "  constexpr int KS = (9 * P + 15) / 16, K = 9 * P, RS = bc_row(P), OFF = 8 - P;\n",
                                "  constexpr int KS = (9 * P + 15) / 16, K = 9 * P, RS = bc_row(P), OFF = 8 - P;\n  if (p.B) return;\n"),
    "diag_narrowbf16_o_empty": ("narrowbf16", "  constexpr int kSteps = kFold ? 3 : 9;",
                                "  constexpr int kSteps = kFold ? 3 : 9;\n  if (p.B) return;"),
    "diag_narrowbf16_o_no_tiles": ("narrowbf16", "  const int nsteps = mine * nkc;",
                                   "  const int nsteps = 0 * mine;"),
    "diag_narrowbf16_o_no_copies": ("narrowbf16", "  auto issue = [&](int s) {\n",
                                    "  auto issue = [&](int s) {\n    if (s >= 0) return;\n"),
}
# name -> (kernel, text, the replacement) as VARIANTS, but changing the first
# file given (say, a parent commit's source) instead of the package's own
FILE_VARIANTS = {
    # diagnostics of the CUDA-core bf16 narrow kernels that widened their
    # tiles to fp32 (results wrong; the time of the rest), given as the
    # first file:
    # narrow_c_kernel without its per-block weight restaging, its products or
    # its stores, and with its bf16 stores as one 8-byte store a pixel;
    # narrow_o_kernel without its products, its x staging or its weights'
    "diag_parent_c_no_wstage": ("narrowbf16", "idx < 9 * kKC * kCO; idx += kCThreads",
                                "idx < 0; idx += kCThreads"),
    "diag_parent_c_no_mma": ("narrowbf16", "    for (int c4 = 0; c4 < nq; ++c4) {\n#pragma unroll\n      for (int dc = 0; dc < 3; ++dc) {\n        float4 xv[kCRows + 2];",
                             "    for (int c4 = 0; c4 < 0; ++c4) {\n#pragma unroll\n      for (int dc = 0; dc < 3; ++dc) {\n        float4 xv[kCRows + 2];"),
    "diag_parent_c_no_stores": ("narrowbf16", "      } else if (ob < O) {\n        store_out(",
                                "      } else if (ob < 0) {\n        store_out("),
    "diag_parent_c_wide_stores": (
        "narrowbf16",
        "  if (vec && n % 2 == 0) {\n    for (int i = 0; i < n; i += 2)",
        "  if (vec && n == 4 && (uintptr_t)dst % 8 == 0) {\n    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);\n    *reinterpret_cast<uint2*>(dst) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));\n  } else if (vec && n % 2 == 0) {\n    for (int i = 0; i < n; i += 2)"),
    "diag_parent_o_no_mma": ("narrowbf16", "    for (int c4 = 0; c4 < nq; ++c4) {\n#pragma unroll\n      for (int dc = 0; dc < 3; ++dc) {\n        float4 xv[6];",
                             "    for (int c4 = 0; c4 < 0; ++c4) {\n#pragma unroll\n      for (int dc = 0; dc < 3; ++dc) {\n        float4 xv[6];"),
    "diag_parent_o_no_x": ("narrowbf16", "    load_tile<kOIH, kOIW>(sx + stage * kOStageX, xb, ty0, tx0, p.H, p.W, C, c0, kOKC,\n                          kOPS, p.vec, tid, kOThreads);\n",
                           ""),
    "diag_parent_o_no_w": ("narrowbf16", "idx < 9 * kOKC * OP; idx += kOThreads",
                           "idx < 0; idx += kOThreads"),
}
N, L, D = 16, 1024, 64
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the kernel -> its package source and the argument types of its entry points
KERNELS = {
    "k4": ("fused_attention.cu", {"mc_attention_fwd": [P] * 5 + [I, I, I, F, P],
                                  "mc_attention_bwd": [P] * 10 + [I, I, I, F, P]}),
    # the dq and dk/dv entry points apart are optional: set per library
    "k4bf16": ("fused_attention.cu", {"mc_attention_fwd_bf16": [P] * 6 + [I, I, I, F, P],
                                      "mc_attention_bwd_bf16": [P] * 10 + [I, I, I, F, P]}),
    "k6": ("linear_attention.cu", {"mc_apply_dots": [P] * 3 + [I] * 4 + [P]}),
    # the TMA entry points are optional: set per library
    "k6bf16": ("linear_attention.cu", {"mc_apply_dots_bf16": [P, P, I, P] + [I] * 4 + [P]}),
    "k5bf16": ("linear_attention.cu", {"mc_kv_dots_bf16": [P] * 4 + [I] * 6 + [P]}),
    "k2": ("fused_norm_conv.cu", {"mc_gn_silu_conv": [P] * 13 + [I] * 7 + [F, I, I, P],
                                  "mc_gn_silu_up_conv": [P] * 10 + [I] * 6 + [F, P]}),
    "k2bf16": ("fused_norm_conv.cu",
               {"mc_gn_silu_conv_bf16": [P] * 13 + [I] * 7 + [F, I, I, P],
                "mc_gn_silu_up_conv_bf16": [P] * 10 + [I] * 6 + [F, P]}),
    "k5": ("linear_attention.cu", {"mc_kv_dots": [P] * 4 + [I] * 6 + [P]}),
    "k7": ("fused_block.cu", {"mc_unet_block": [P] * 22 + [I] * 8 + [F, I, P]}),
    "k7bf16": ("fused_block.cu", {"mc_unet_block_bf16": [P] * 22 + [I] * 8 + [F, I, P],
                                  "mc_unet_block_bf16_plan": [I] * 8 + [P]}),
    # two interfaces (see _time_k2bwd, _time_k1bwd): argument types are set
    # per library
    "k2bwd": ("fused_norm_conv_bwd.cu", {}),
    "k2bwdbf16": ("fused_norm_conv_bwd.cu", {}),
    "k1bwd": ("fused_norm.cu", {}),
    "k1bwdbf16": ("fused_norm.cu", {}),
    "wgradnarrowbf16": ("fused_norm_conv_bwd.cu", {
        "mc_conv_wgrad_bf16": [P] * 8 + [I] * 6 + [F] + [I] * 5 + [P],
        "mc_conv_bwd_bf16_plan": [I] * 8 + [P]}),
    "k1bf16": ("fused_norm.cu", {"mc_channel_stats_bf16": [P] * 3 + [I] * 3 + [P],
                                 "mc_channel_stats": [P] * 3 + [I] * 3 + [P],
                                 "mc_gn_silu_bf16": [P] * 6 + [I] * 4 + [F, P],
                                 "mc_gn_silu": [P] * 6 + [I] * 4 + [F, P]}),
    "narrowbf16": ("narrow_conv.cu", {"mc_narrow_conv_bf16": [P] * 6 + [I] * 5 + [P],
                                      "mc_narrow_conv": [P] * 6 + [I] * 5 + [P],
                                      "mc_narrow_conv_bwd_bf16": [P] * 6 + [I] * 6 + [P],
                                      "mc_narrow_conv_tiles": [I] * 3}),
    "mma": (None, {}),
}
K6_BH, K6_N, K6_W = (16, 64), 16384, 128
K2_B, K2_RES, K2_CH = 16, 128, 64


def _cuda_ms(fn, runs: int = 10, per_run: int = 10) -> float:
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


def _sources(kernel, files, variants, out_dir: Path):
    own = _build.CSRC / KERNELS[kernel][0]
    srcs = {"package": own}
    for i, f in enumerate(files):
        srcs[f"file{i}:{f}"] = Path(f)
    for name in variants:
        # FILE_VARIANTS change the first file given, VARIANTS the package's
        # own source or one of its headers
        on_file = name in FILE_VARIANTS
        _, old, new, *header = FILE_VARIANTS[name] if on_file else VARIANTS[name]
        if on_file and not files:
            raise ValueError(f"variant {name} changes the first file given: give one")
        base = Path(files[0]) if on_file else _build.CSRC / header[0] if header else own
        text = base.read_text()
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: its text is not in {base}")
        text = text.replace(old, new)
        if header:
            # the changed header beside a copy of the source, which nvcc's
            # quoted include finds before the package's
            (out_dir / name).mkdir(exist_ok=True)
            (out_dir / name / header[0]).write_text(text)
            path = out_dir / name / own.name
            path.write_text(own.read_text())
        else:
            path = out_dir / f"variant_{name}.cu"
            path.write_text(text)
        srcs[f"variant:{name}"] = path
    return srcs


def _build_libs(kernel, srcs, out_dir: Path):
    procs = {}
    for i, (name, src) in enumerate(srcs.items()):
        so = out_dir / f"{kernel}_{i}.so"
        # -I: a variant written elsewhere finds the package's csrc headers
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
               str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs, ptxas = {}, {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if any(k in ln for k in ("registers", "spill", "Function properties",
                                                "warning"))]
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in KERNELS[kernel][1].items():
            getattr(lib, fn).argtypes = argtypes
        libs[name] = (lib, so)
    return libs, ptxas


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("files", nargs="*")
    ap.add_argument("--kernel", default="k4", choices=sorted(KERNELS))
    ap.add_argument("--variant", action="append", default=[],
                    choices=sorted({**VARIANTS, **FILE_VARIANTS}))
    ap.add_argument("--sass", default=None)
    args = ap.parse_args(argv)
    if any({**VARIANTS, **FILE_VARIANTS}[v][0] != args.kernel for v in args.variant):
        ap.error(f"a --variant of another kernel than {args.kernel}")
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    if args.kernel == "mma":
        return _time_mma()
    out_dir = _build.BUILD_DIR / "attention_sources"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, ptxas = _build_libs(args.kernel, _sources(args.kernel, args.files, args.variant,
                                                    out_dir), out_dir)
    if args.sass:
        Path(args.sass).mkdir(parents=True, exist_ok=True)
        for i, (name, (_, so)) in enumerate(libs.items()):
            with open(Path(args.sass) / f"{args.kernel}_{i}.sass", "w") as f:
                subprocess.run(["cuobjdump", "-sass", str(so)], stdout=f,
                               stderr=subprocess.STDOUT, check=False)
    if args.kernel != "k4":
        return {"k4bf16": _time_k4bf16, "k6": _time_k6, "k6bf16": _time_k6bf16,
                "k2": _time_k2, "k2bf16": _time_k2bf16,
                "k2bwd": _time_k2bwd, "k2bwdbf16": _time_k2bwdbf16,
                "k5": _time_k5, "k5bf16": _time_k5bf16, "k7": _time_k7,
                "k7bf16": _time_k7bf16,
                "k1bwd": _time_k1bwd, "k1bf16": _time_k1bf16,
                "k1bwdbf16": _time_k1bwdbf16, "wgradnarrowbf16": _time_wgradnarrowbf16,
                "narrowbf16": _time_narrowbf16}[args.kernel](libs, ptxas)

    dev = torch.device("cuda")
    rs = np.random.RandomState(0)
    q, k, v, g = (torch.from_numpy(rs.randn(N, L, D).astype(np.float32)).to(dev)
                  for _ in range(4))
    q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
    o64 = torch.softmax(q64 @ k64.transpose(1, 2) / 8, dim=-1) @ v64
    want = torch.autograd.grad(o64, (q64, k64, v64), g.double())
    stream = torch.cuda.current_stream().cuda_stream

    def rel(a, w):
        return float((a.double() - w).abs().max()) / max(1.0, float(w.abs().max()))

    def calls(lib):
        o, lse, delta = torch.empty_like(q), q.new_empty(N, L), q.new_empty(N, L)
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        ptrs = [t.data_ptr() for t in (q, k, v)]

        def fwd():
            return lib.mc_attention_fwd(*ptrs, o.data_ptr(), lse.data_ptr(), N, L, D,
                                        0.125, stream)

        def bwd():
            return lib.mc_attention_bwd(*ptrs, o.data_ptr(), g.data_ptr(),
                                        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                                        dk.data_ptr(), dv.data_ptr(), N, L, D, 0.125,
                                        stream)
        return fwd, bwd, (o, dq, dk, dv)

    errs = {}
    for name, (lib, _) in libs.items():
        fwd, bwd, (o, dq, dk, dv) = calls(lib)
        if fwd() or bwd():
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        errs[name] = {"fwd_err": rel(o, o64.detach()),
                      "bwd_err": [rel(a, w) for a, w in zip((dq, dk, dv), want)]}
    names = list(libs)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            fwd, bwd, _ = calls(libs[name][0])
            print(json.dumps({"source": name, "round": rnd, "fwd_ms": _cuda_ms(fwd),
                              "bwd_ms": _cuda_ms(bwd), **errs[name],
                              "ptxas": ptxas[name]}), flush=True)
    return 0


MMA_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// iters rounds of eight independent m16n8k8 TF32 products per warp
__global__ void mma_rate(float* out, int iters) {
  uint32_t a[4], b0 = threadIdx.x, b1 = threadIdx.x * 3u;
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * (i + 7u);
  float c[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
                   : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mc_mma_rate(float* out, int blocks, int threads, int iters, void* stream) {
  mma_rate<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
// iters rounds of eight independent m16n8k16 bf16 products per warp
__global__ void mma_rate_bf16(float* out, int iters) {
  uint32_t a[4], b0 = threadIdx.x, b1 = threadIdx.x * 3u;
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * (i + 7u);
  float c[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                   "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
                   : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mc_mma_rate_bf16(float* out, int blocks, int threads, int iters,
                                void* stream) {
  mma_rate_bf16<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
// iters rounds of eight independent 3xTF32 splits (two cvt.rn.tf32.f32 and
// one subtraction each) per thread
__global__ void split_rate(float* out, int iters) {
  float x[8];
  for (int j = 0; j < 8; ++j) x[j] = threadIdx.x * (j + 1.37f);
  uint32_t acc = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t hi, lo;
      asm volatile("cvt.rn.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x[j]));
      asm volatile("cvt.rn.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x[j] - __uint_as_float(hi)));
      acc ^= hi ^ lo;
      x[j] = __uint_as_float(lo) + 1.0001f * x[j];
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = (float)acc;
}
extern "C" int mc_split_rate(float* out, int blocks, int threads, int iters, void* stream) {
  split_rate<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def _time_mma() -> int:
    """TF32 mma.sync.m16n8k8 products per second on the card, with blocks of
    4 warps filling 4 to 32 warps an SM; then the 3xTF32 split's rate; then
    bf16 mma.sync.m16n8k16's rate, as the TF32 one."""
    out_dir = _build.BUILD_DIR / "attention_sources"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, so = out_dir / "mma_rate.cu", out_dir / "mma_rate.so"
    src.write_text(MMA_SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.mc_mma_rate.argtypes = [P, I, I, I, P]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    iters = 4096
    for warps in (4, 8, 16, 32):
        blocks = sms * warps // 4
        out = torch.empty(blocks * 128, device=dev)
        ms = _cuda_ms(lambda: lib.mc_mma_rate(out.data_ptr(), blocks, 128, iters, stream))
        flops = 2.0 * 16 * 8 * 8 * 8 * iters * blocks * 4
        print(json.dumps({"warps_per_sm": warps, "ms": ms,
                          "tf32_tflops": flops / ms / 1e9,
                          "ns_per_mma_per_sm": ms * 1e6 / (flops / 2048 / sms)}),
              flush=True)
    lib.mc_split_rate.argtypes = [P, I, I, I, P]
    iters = 1024
    for warps in (16, 32):
        blocks = sms * warps // 4
        out = torch.empty(blocks * 128, device=dev)
        ms = _cuda_ms(lambda: lib.mc_split_rate(out.data_ptr(), blocks, 128, iters, stream))
        splits = 8.0 * iters * blocks * 128
        print(json.dumps({"warps_per_sm": warps, "ms": ms,
                          "split_warp_instr_per_ns_per_sm": splits / 32 / ms / 1e6 / sms}),
              flush=True)
    lib.mc_mma_rate_bf16.argtypes = [P, I, I, I, P]
    iters = 4096
    for warps in (4, 8, 16, 32):
        blocks = sms * warps // 4
        out = torch.empty(blocks * 128, device=dev)
        ms = _cuda_ms(lambda: lib.mc_mma_rate_bf16(out.data_ptr(), blocks, 128, iters,
                                                   stream))
        flops = 2.0 * 16 * 8 * 16 * 8 * iters * blocks * 4
        print(json.dumps({"instruction": "mma.sync.m16n8k16 bf16", "warps_per_sm": warps,
                          "ms": ms, "bf16_tflops": flops / ms / 1e9,
                          "ns_per_mma_per_sm": ms * 1e6 / (flops / 4096 / sms)}),
              flush=True)
    return 0


def _rel(got, want) -> float:
    return float((got.double() - want).abs().max()) / max(1.0, float(want.abs().max()))


def _report(libs, ptxas, calls, errs, timer=_cuda_ms) -> None:
    """Time calls[name][case]() for every source by `timer`, in two rounds of
    opposite order, and print one line per source and round."""
    names = list(libs)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            print(json.dumps({"source": name, "round": rnd,
                              **{f"ms {case}": timer(fn)
                                 for case, fn in calls[name].items()},
                              **errs[name], "ptxas": ptxas[name]}), flush=True)


K4_BF16_N = (16, 80)


def _time_k4bf16(libs, ptxas) -> int:
    """The bf16 K4 of every source at N = 16 and 80 (L = 1024, D = 64):
    forward with and without o32, the backward, and its dq and dk/dv kernels
    apart where exported; checked against the bf16 plain version and for the
    same bits on a repeat, then timed on the card's clock; bf16 SDPA's
    forward and backward beside them."""
    import torch.nn.functional as tnf

    from m_cedm_tpu_torch.kernels import fused_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    bf = torch.bfloat16
    split_if = {}
    for name, (lib, so) in libs.items():
        split_if[name] = hasattr(lib, "mc_attention_bwd_dq_bf16")
        if split_if[name]:
            lib.mc_attention_bwd_dq_bf16.argtypes = [P] * 8 + [I, I, I, F, P]
            lib.mc_attention_bwd_dkdv_bf16.argtypes = [P] * 8 + [I, I, I, F, P]
        print(json.dumps({"source": name, "sass": _build.sass_counts(so, "_bf16_kernel")}),
              flush=True)

    def bf16_err(got, want):
        err = (got.double() - want.double()).abs()
        scale = max(float(want.double().abs().max()), 1e-30)
        return float(err.max()) / scale, float(err.mean()) / scale

    cases = {}
    for n in K4_BF16_N:
        q, k, v, g = (torch.randn(n, L, D, generator=gen, device=dev).to(bf) for _ in range(4))
        with torch.no_grad():
            want = fa.attention_plain(q, k, v)
            want32 = fa.attention_plain(q.float(), k.float(), v.float())
            want_bwd = fa.attention_bwd_plain(g, q, k, v)
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        sd = tnf.scaled_dot_product_attention(qs[:, None], ks[:, None], vs[:, None])[:, 0]
        cases[n] = dict(q=q, k=k, v=v, g=g, want=want, want32=want32, want_bwd=want_bwd,
                        sdpa=(qs, ks, vs, sd))

    def call(name, lib, c, n):
        q, k, v, g = (c[x].data_ptr() for x in "qkvg")
        o, dq, dk, dv = (torch.empty_like(c["q"]) for _ in range(4))
        o32 = torch.empty(n, L, D, device=dev)
        lse, delta = torch.empty(n, L, device=dev), torch.empty(n, L, device=dev)
        outs = dict(o=o, o32=o32, dq=dq, dk=dk, dv=dv)

        def check(rc):
            if rc:
                raise RuntimeError(f"{name}: launch failed with cudaError {rc}")

        def fwd():
            check(lib.mc_attention_fwd_bf16(q, k, v, o.data_ptr(), None, lse.data_ptr(),
                                            n, L, D, 0.125, stream))

        def fwd_o32():
            check(lib.mc_attention_fwd_bf16(q, k, v, o.data_ptr(), o32.data_ptr(),
                                            lse.data_ptr(), n, L, D, 0.125, stream))

        def bwd():
            check(lib.mc_attention_bwd_bf16(q, k, v, o32.data_ptr(), g, lse.data_ptr(),
                                            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                            dv.data_ptr(), n, L, D, 0.125, stream))
        fns = {f"fwd N {n}": fwd, f"fwd with o32 N {n}": fwd_o32, f"bwd N {n}": bwd}
        if split_if[name]:
            fns[f"bwd dq N {n}"] = lambda: check(lib.mc_attention_bwd_dq_bf16(
                q, k, v, o32.data_ptr(), g, lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                n, L, D, 0.125, stream))
            fns[f"bwd dk/dv N {n}"] = lambda: check(lib.mc_attention_bwd_dkdv_bf16(
                q, k, v, g, lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                n, L, D, 0.125, stream))
        return fns, outs

    calls, errs = {}, {}
    for name, (lib, _) in libs.items():
        calls[name], errs[name] = {}, {}
        for n, c in cases.items():
            fns, outs = call(name, lib, c, n)
            fns[f"fwd with o32 N {n}"]()
            fns[f"bwd N {n}"]()
            torch.cuda.synchronize()
            first = [outs[x].clone() for x in ("dq", "dk", "dv")]
            fns[f"bwd N {n}"]()
            torch.cuda.synchronize()
            rec = {"fwd": bf16_err(outs["o"], c["want"]),
                   "o32": _rel(outs["o32"], c["want32"].double()),
                   "bwd": [bf16_err(outs[x], w) for x, w in zip(("dq", "dk", "dv"),
                                                                c["want_bwd"])],
                   "same bits": all(torch.equal(a, outs[x])
                                    for a, x in zip(first, ("dq", "dk", "dv")))}
            errs[name][f"err N {n}"] = rec
            calls[name].update(fns)
        for n, c in cases.items():
            qs, ks, vs, sd = c["sdpa"]
            calls[name][f"bf16 SDPA fwd N {n} (library)"] = (
                lambda c=c: tnf.scaled_dot_product_attention(
                    c["q"][:, None], c["k"][:, None], c["v"][:, None]))
            calls[name][f"bf16 SDPA bwd N {n} (library)"] = (
                lambda qs=qs, ks=ks, vs=vs, sd=sd, g=c["g"]: torch.autograd.grad(
                    sd, (qs, ks, vs), g, retain_graph=True))
    _report(libs, ptxas, calls, errs, timer=lambda fn: device_ms(fn, repeats=5))
    return 0


def _time_k6(libs, ptxas) -> int:
    """mc_apply_dots of every source at BH 16 and 64, checked, then timed."""
    dev = torch.device("cuda")
    rs = np.random.RandomState(0)
    stream = torch.cuda.current_stream().cuda_stream
    cases = {}
    for bh in K6_BH:
        q = torch.from_numpy(rs.randn(bh, K6_N, K6_W).astype(np.float32)).to(dev)
        dots = torch.from_numpy((rs.randn(bh, K6_W, K6_W) / 8).astype(np.float32)).to(dev)
        cases[bh] = (q, dots, torch.empty_like(q), q.double() @ dots.double())

    def call(lib, bh):
        q, dots, out, _ = cases[bh]
        return lambda: lib.mc_apply_dots(q.data_ptr(), dots.data_ptr(), out.data_ptr(),
                                         bh, K6_N, K6_W, K6_W, stream)

    errs = {}
    for name, (lib, _) in libs.items():
        errs[name] = {}
        for bh in K6_BH:
            if call(lib, bh)():
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            out, want = cases[bh][2], cases[bh][3]
            errs[name][f"err_bh_{bh}"] = (float((out.double() - want).abs().max())
                                          / max(1.0, float(want.abs().max())))
    names = list(libs)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            lib = libs[name][0]
            print(json.dumps({"source": name, "round": rnd,
                              **{f"ms_bh_{bh}": _cuda_ms(call(lib, bh)) for bh in K6_BH},
                              **errs[name], "ptxas": ptxas[name]}), flush=True)
    return 0


def _time_k2(libs, ptxas) -> int:
    """mc_gn_silu_conv / mc_gn_silu_up_conv of every source at the flagship's
    K2 and K3 shapes, checked against float64, then timed."""
    from m_cedm_tpu_torch.kernels import fused_norm_conv as fnc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    b, res, ch = K2_B, K2_RES, K2_CH

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + shift

    def conv_w(ci, co):
        return rnd(3, 3, ci, co, scale=1.0 / ci ** 0.5 / 3)

    w, bias = conv_w(ch, ch), rnd(ch, scale=0.3)
    w2 = conv_w(2 * ch, ch)
    skw, skb = rnd(2 * ch, ch, scale=(2 * ch) ** -0.5), rnd(ch, scale=0.3)
    cases = {}

    def k2(name, x, act, *, res=None, res_mode=0, skip_w=None, skip_b=None,
           emit=False, wt=w, up=False):
        c = x.shape[-1]
        gamma, beta = (rnd(b, c, scale=0.3, shift=1.0), rnd(b, c, scale=0.3)) if act \
            else (None, None)
        sums = fnc._out_stats_plain(x) if act else (None, None)
        h_out, w_out = (2 * x.shape[1], 2 * x.shape[2]) if up else x.shape[1:3]
        kw = {}
        if res_mode == 1:
            kw = dict(residual=res)
        elif res_mode == 2:
            kw = dict(residual=res, res_up=True)
        elif res_mode == 3:
            kw = dict(residual=res, skip_w=skip_w, skip_b=skip_b)
        args64 = [None if t is None else t.double()
                  for t in (x, gamma, beta, wt, bias)]
        kw64 = {k: (v.double() if torch.is_tensor(v) else v) for k, v in kw.items()}
        groups = 32 if act else 0
        if up:
            want = fnc.gn_silu_up_conv_plain(*args64, groups, emit_stats=emit)
        else:
            want = fnc.gn_silu_conv_plain(*args64, groups, emit_stats=emit, **kw64)
        want = want if emit else (want, (None, None))
        out = torch.empty(b, h_out, w_out, ch, device=dev)
        osums = torch.zeros(b, ch, device=dev) if emit else None
        osumsq = torch.zeros(b, ch, device=dev) if emit else None
        cases[name] = dict(x=x, gamma=gamma, beta=beta, w=wt, sums=sums, res=res,
                           res_mode=res_mode, skip_w=skip_w, skip_b=skip_b, out=out,
                           osums=osums, osumsq=osumsq, act=int(act), up=up,
                           want=want, cr=skip_w.shape[0] if skip_w is not None else 0)

    h = rnd(b, res, res, ch, scale=0.8, shift=0.2)
    xc = rnd(b, res, res, 2 * ch, scale=0.8, shift=0.2)
    k2("identity, chained stats, res 128", h, True, res=rnd(b, res, res, ch), res_mode=1)
    k2("identity, emit_stats, res 128", h, True, res=rnd(b, res, res, ch), res_mode=1,
       emit=True)
    k2("identity_up, emit_stats, res 128", h, True,
       res=rnd(b, res // 2, res // 2, ch), res_mode=2, emit=True)
    k2("proj from the 128-channel concat, emit_stats, res 128", h, True, res=xc,
       res_mode=3, skip_w=skw, skip_b=skb, emit=True)
    k2("128-channel input, emit_stats, res 128", xc, True, emit=True, wt=w2)
    k2("act=False (down conv0), res 64",
       rnd(b, res // 2, res // 2, ch, scale=0.8, shift=0.2), False)
    for r in (res // 2, res // 4):
        k2(f"identity, chained stats, res {r}",
           rnd(b, r, r, ch, scale=0.8, shift=0.2), True, res=rnd(b, r, r, ch), res_mode=1)
    k2("K3 up conv0, chained stats, emit_stats, to res 128",
       rnd(b, res // 2, res // 2, ch, scale=0.8, shift=0.2), True, emit=True, up=True)

    def call(lib, c):
        p = [None if t is None else t.data_ptr() for t in (
            c["x"], c["w"], bias, c["gamma"], c["beta"], *c["sums"], c["res"],
            c["skip_w"], c["skip_b"], c["out"], c["osums"], c["osumsq"])]
        bb, hh, ww, o = c["out"].shape
        cin = c["x"].shape[-1]

        def fn():
            if c["osums"] is not None:
                c["osums"].zero_()
                c["osumsq"].zero_()
            if c["up"]:
                rc = lib.mc_gn_silu_up_conv(*p[:7], *p[10:], bb, hh, ww, cin, o, 32,
                                            1e-5, stream)
            else:
                rc = lib.mc_gn_silu_conv(*p, bb, hh, ww, cin, o, c["cr"],
                                         32 if c["act"] else 1, 1e-5, c["act"],
                                         c["res_mode"], stream)
            if rc:
                raise RuntimeError(f"launch failed with cudaError {rc}")
        return fn

    calls, errs = {}, {}
    for name, (lib, _) in libs.items():
        calls[name] = {case: call(lib, c) for case, c in cases.items()}
        errs[name] = {}
        for case, c in cases.items():
            calls[name][case]()
            torch.cuda.synchronize()
            out, (ws, wss) = c["want"]
            errs[name][f"err {case}"] = max(
                [_rel(c["out"], out)] + ([_rel(c["osums"], ws), _rel(c["osumsq"], wss)]
                                         if ws is not None else []))
    _report(libs, ptxas, calls, errs)
    return 0


def _time_k2bf16(libs, ptxas) -> int:
    """mc_gn_silu_conv_bf16 / mc_gn_silu_up_conv_bf16 of every source at
    chip_smoke.py phase 15.1's K2 and K3 cases, checked against the bf16
    plain version, then timed; bf16 conv2d beside the linear mode."""
    import torch.nn.functional as tnf

    from m_cedm_tpu_torch.kernels import fused_norm as fn
    from m_cedm_tpu_torch.kernels import fused_norm_conv as fnc
    from m_cedm_tpu_torch.models.layers import adm_groups

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    b, res, ch = K2_B, K2_RES, K2_CH
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0, shift=0.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)

    def conv_w(ci, co):
        return rnd(3, 3, ci, co, scale=(9 * ci) ** -0.5)

    w, bias = conv_w(ch, ch), rnd(ch, scale=0.3, dtype=torch.float32)
    cases = {}

    def k2(name, x, act, *, res_=None, res_mode=0, skip_w=None, skip_b=None,
           emit=False, wt=w, up=False):
        c = x.shape[-1]
        gamma, beta = ((rnd(b, c, scale=0.3, shift=1.0, dtype=torch.float32),
                        rnd(b, c, scale=0.3, dtype=torch.float32)) if act else (None, None))
        groups = adm_groups(c) if act else 0
        stats = fn.channel_stats_plain(x.reshape(b, -1, c)) if act else None
        kw = {}
        if res_mode == 1:
            kw = dict(residual=res_)
        elif res_mode == 2:
            kw = dict(residual=res_, res_up=True)
        elif res_mode == 3:
            kw = dict(residual=res_, skip_w=skip_w, skip_b=skip_b)
        with torch.no_grad():
            if up:
                want = fnc.gn_silu_up_conv_plain(x, gamma, beta, wt, bias, groups,
                                                 stats=stats, emit_stats=emit)
            else:
                want = fnc.gn_silu_conv_plain(x, gamma, beta, wt, bias, groups, stats=stats,
                                              emit_stats=emit, **kw)
        want = want if emit else (want, (None, None))
        h_out, w_out = (2 * x.shape[1], 2 * x.shape[2]) if up else x.shape[1:3]
        cases[name] = dict(
            x=x, gamma=gamma, beta=beta, w=wt, sums=stats or (None, None), res=res_,
            res_mode=res_mode, skip_w=skip_w, skip_b=skip_b, act=int(act), up=up,
            groups=max(groups, 1), want=want, cr=skip_w.shape[0] if skip_w is not None else 0,
            out=torch.empty(b, h_out, w_out, wt.shape[-1], device=dev, dtype=bf),
            osums=torch.zeros(b, wt.shape[-1], device=dev) if emit else None,
            osumsq=torch.zeros(b, wt.shape[-1], device=dev) if emit else None)

    h = rnd(b, res, res, ch, scale=0.8, shift=0.2)
    xc = rnd(b, res, res, 2 * ch, scale=0.8, shift=0.2)
    xl = rnd(b, res // 2, res // 2, ch, scale=0.8, shift=0.2)
    k2("identity, chained stats, res 128", h, True, res_=rnd(b, res, res, ch), res_mode=1)
    k2("identity, emit_stats, res 128", h, True, res_=rnd(b, res, res, ch), res_mode=1,
       emit=True)
    k2("identity_up, emit_stats, res 128", h, True, res_=rnd(b, res // 2, res // 2, ch),
       res_mode=2, emit=True)
    k2("proj from the 128-channel concat, emit_stats, res 128", h, True, res_=xc,
       res_mode=3, skip_w=rnd(2 * ch, ch, scale=(2 * ch) ** -0.5),
       skip_b=rnd(ch, scale=0.3, dtype=torch.float32), emit=True)
    k2("128-channel input, emit_stats, res 128", xc, True, emit=True, wt=conv_w(2 * ch, ch))
    k2("act=False (down conv0), emit_stats, res 64", xl, False, emit=True)
    for r in (res // 2, res // 4):
        k2(f"identity, chained stats, res {r}", rnd(b, r, r, ch, scale=0.8, shift=0.2), True,
           res_=rnd(b, r, r, ch), res_mode=1)
    k2("K3 up conv0, chained stats, emit_stats, to res 128", xl, True, emit=True, up=True)

    def call(lib, c):
        p = [None if t is None else t.data_ptr() for t in (
            c["x"], c["w"], bias, c["gamma"], c["beta"], *c["sums"], c["res"],
            c["skip_w"], c["skip_b"], c["out"], c["osums"], c["osumsq"])]
        bb, hh, ww, o = c["out"].shape
        cin = c["x"].shape[-1]

        def fn_():
            if c["osums"] is not None:
                c["osums"].zero_()
                c["osumsq"].zero_()
            if c["up"]:
                rc = lib.mc_gn_silu_up_conv_bf16(*p[:7], *p[10:], bb, hh, ww, cin, o,
                                                 c["groups"], 1e-5, stream)
            else:
                rc = lib.mc_gn_silu_conv_bf16(*p, bb, hh, ww, cin, o, c["cr"], c["groups"],
                                              1e-5, c["act"], c["res_mode"], stream)
            if rc:
                raise RuntimeError(f"launch failed with cudaError {rc}")
        return fn_

    def plan(lib, c):
        try:
            fn_ = lib.mc_gn_silu_conv_bf16_plan
        except AttributeError:
            return None
        fn_.argtypes = [I] * 10 + [P]
        out = (ctypes.c_int * 5)()
        bb, hh, ww, o = c["out"].shape
        rc = fn_(int(c["up"]), bb, hh, ww, c["x"].shape[-1], o, c["cr"], c["act"],
                 c["res_mode"], int(c["osums"] is not None), out)
        return dict(zip(("tile_rows", "resident", "blocks", "smem", "blocks_per_sm"),
                        list(out))) if rc == 0 else {"error": rc}

    def bf16_err(got, want):
        err = (got.double() - want.double()).abs()
        scale = max(float(want.double().abs().max()), 1e-30)
        return float(err.max()) / scale, float(err.mean()) / scale

    calls, errs = {}, {}
    for name, (lib, _) in libs.items():
        calls[name] = {case: call(lib, c) for case, c in cases.items()}
        errs[name] = {}
        for case, c in cases.items():
            calls[name][case]()
            torch.cuda.synchronize()
            out, (ws, wss) = c["want"]
            mx, mean = bf16_err(c["out"], out)
            rec = {"max": mx, "mean": mean}
            if ws is not None:
                rec["stats_max"] = max(bf16_err(c["osums"], ws)[0],
                                       bf16_err(c["osumsq"], wss)[0])
            rec["plan"] = plan(lib, c)
            errs[name][f"err {case}"] = rec
    lin = cases["act=False (down conv0), emit_stats, res 64"]

    def conv2d():
        return tnf.conv2d(lin["x"].permute(0, 3, 1, 2), lin["w"].permute(3, 2, 0, 1),
                          bias.to(bf), padding=1)
    for name in libs:
        calls[name]["bf16 conv2d, the linear case (library)"] = conv2d
    _report(libs, ptxas, calls, errs)
    return 0

# the CUDA-core backward's wgrad blocks (16 input x 64 output channels) and
# split rule, for a source without mc_conv_bwd_tiles
_OLD_WGRAD_BLOCKS = 4 * 132


def _time_k2bwd(libs, ptxas) -> int:
    """mc_conv_wgrad / mc_conv_dgrad of every source at the flagship train
    step's K2 / K3 backward shapes, each kernel checked against float64 and
    then timed alone (its reduce included)."""
    from m_cedm_tpu_torch.kernels import fused_norm_conv as fnc
    from m_cedm_tpu_torch.kernels.fused_norm import (group_mean_rstd_from_sums,
                                                     silu_grad)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    b, res, ch, groups, eps = K2_B, K2_RES, K2_CH, 32, 1e-5
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    new_if = {name: hasattr(lib, "mc_conv_bwd_tiles") for name, (lib, _) in libs.items()}
    for name, (lib, _) in libs.items():
        lib.mc_conv_dgrad.argtypes = [P] * 10 + [I] * 6 + [F, I, P]
        lib.mc_conv_wgrad.argtypes = ([P] * 8 + [I] * 6 + [F] + [I] * 5 + [P] if new_if[name]
                                      else [P] * 8 + [I] * 6 + [F] + [I] * 4 + [P])
        if new_if[name]:
            lib.mc_conv_bwd_tiles.argtypes = [I] * 3
            lib.mc_conv_wgrad_runs.argtypes = [I] * 8

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + shift

    cases = {}

    def case(name, x, o, act, up=False, taps=9, dgrad=True):
        """x the conv input (K3: low-res), o output channels."""
        bb, hin, win, c = x.shape
        h, wd = (2 * hin, 2 * win) if up else (hin, win)
        g = rnd(bb, h, wd, o)
        w = rnd(3, 3, c, o, scale=(9 * c) ** -0.5)
        gamma = beta = sums = sumsq = None
        x64 = s64 = x.double()
        if act:
            gamma, beta = rnd(bb, c, scale=0.3, shift=1.0), rnd(bb, c, scale=0.3)
            sums, sumsq = fnc._out_stats_plain(x)
            mean, rstd = group_mean_rstd_from_sums(sums.double(), sumsq.double(),
                                                   hin * win, groups, eps)
            xhat = (x64 - mean[:, None, None]) * rstd[:, None, None]
            a = xhat * gamma.double()[:, None, None] + beta.double()[:, None, None]
            s64 = a * torch.sigmoid(a)
        g64 = g.double()
        if taps == 1:
            dw64 = torch.einsum("bhwc,bhwo->co", s64, g64)
        else:
            dw64 = fnc.conv3x3_wgrad_plain(fnc.upsample2x_nearest(s64) if up else s64, g64)
        want_w = [dw64.reshape(-1)] + ([g64.sum(dim=(0, 1, 2))] if taps == 9 else [])
        want_d = None
        if dgrad:
            ds = fnc.conv3x3_dgrad_plain(g64, w.double())
            if up:
                want_d = [ds.reshape(bb, h, wd // 2, 2, c).sum(dim=3)]
            elif act:
                da = ds * silu_grad(a)
                want_d = [da, (da * xhat).sum(dim=(1, 2)), da.sum(dim=(1, 2))]
            else:
                want_d = [ds]
        cases[name] = dict(x=x, g=g, w=w, gamma=gamma, beta=beta, sums=sums,
                           sumsq=sumsq, act=act, up=up, taps=taps, h=h, wd=wd, c=c,
                           o=o, want_w=want_w, want_d=want_d)

    h = rnd(b, res, res, ch, scale=0.8, shift=0.2)
    xc = rnd(b, res, res, 2 * ch, scale=0.8, shift=0.2)
    case("res-128 identity tail", h, ch, True)
    case("decoder 128-channel conv0, res 128", xc, ch, True)
    case("1x1 projection from the 128-channel concat, res 128", xc, ch, False,
         taps=1, dgrad=False)
    case("linear down conv0, res 64", rnd(b, res // 2, res // 2, ch, scale=0.8, shift=0.2),
         ch, False)
    case("conv_in (C 4), res 128", rnd(b, res, res, 4), ch, False, dgrad=False)
    case("K3 up conv0, res 64 -> 128", rnd(b, res // 2, res // 2, ch, scale=0.8, shift=0.2),
         ch, True, up=True)

    def calls(name, lib, cs):
        """(wgrad call, dgrad call or None, outputs) of one source."""
        new = new_if[name]
        x, g, c, o, taps = cs["x"], cs["g"], cs["c"], cs["o"], cs["taps"]
        bb, hh, ww = g.shape[:3]
        pp = [None if t is None else t.data_ptr()
              for t in (cs["gamma"], cs["beta"], cs["sums"], cs["sumsq"])]
        gr, act, up = groups if cs["act"] else 1, int(cs["act"]), int(cs["up"])
        bias = taps == 9
        if new:
            runs = lib.mc_conv_wgrad_runs(bb, hh, ww, c, o, taps, up, fnc._BLOCKS_PER_SM * sms)
            k = taps * c * o + (o if bias else 0)
            dwb, part = g.new_empty(k), g.new_empty(bb * runs, k)

            def wgrad():
                return lib.mc_conv_wgrad(x.data_ptr(), g.data_ptr(), *pp, dwb.data_ptr(),
                                         part.data_ptr(), bb, hh, ww, c, o, gr, eps, act,
                                         taps, up, int(bias), runs, stream)
            w_out = [dwb]
        else:
            tiles = -(-hh // 8) * -(-ww // 16)
            splits = min(tiles, max(1, -(-_OLD_WGRAD_BLOCKS // (bb * -(-c // 16) * -(-o // 64)))))
            dw, db = g.new_empty(taps * c * o), g.new_empty(o)

            def wgrad():
                dw.zero_()
                db.zero_()
                return lib.mc_conv_wgrad(x.data_ptr(), g.data_ptr(), *pp, dw.data_ptr(),
                                         db.data_ptr() if bias else None, bb, hh, ww, c, o,
                                         gr, eps, act, taps, up, splits, stream)
            w_out = [dw, db] if bias else [dw]
        dgrad, d_out = None, []
        if cs["want_d"] is not None:
            mode = 2 if up else act
            out = g.new_empty(bb, hh, ww // 2 if up else ww, c)
            d_out = [out]
            xp = None if up else x.data_ptr()
            pd = [None] * 4 if up else pp
            if new:
                dt = lib.mc_conv_bwd_tiles(hh, ww, 0)
                dstats, dpart = g.new_empty(2, bb, c), g.new_empty(2, bb, dt, c)
                if mode == 1:
                    d_out += [dstats[0], dstats[1]]

                def dgrad():
                    return lib.mc_conv_dgrad(g.data_ptr(), cs["w"].data_ptr(), xp, *pd,
                                             out.data_ptr(), dstats.data_ptr(),
                                             dpart.data_ptr(), bb, hh, ww, c, o, gr, eps,
                                             mode, stream)
            else:
                dgam, dbet = g.new_empty(bb, c), g.new_empty(bb, c)
                if mode == 1:
                    d_out += [dgam, dbet]

                def dgrad():
                    dgam.zero_()
                    dbet.zero_()
                    return lib.mc_conv_dgrad(g.data_ptr(), cs["w"].data_ptr(), xp, *pd,
                                             out.data_ptr(), dgam.data_ptr(),
                                             dbet.data_ptr(), bb, hh, ww, c, o, gr, eps,
                                             mode, stream)
        return wgrad, dgrad, w_out, d_out

    def checked(fn):
        def call():
            rc = fn()
            if rc:
                raise RuntimeError(f"launch failed with cudaError {rc}")
        return call

    timed, errs = {}, {}
    for name, (lib, _) in libs.items():
        timed[name], errs[name] = {}, {}
        for cname, cs in cases.items():
            wgrad, dgrad, w_out, d_out = calls(name, lib, cs)
            checked(wgrad)()
            timed[name][f"wgrad {cname}"] = checked(wgrad)
            if dgrad is not None:
                checked(dgrad)()
                timed[name][f"dgrad {cname}"] = checked(dgrad)
            torch.cuda.synchronize()
            got_w = [torch.cat([t.reshape(-1) for t in w_out])]
            want_w = [torch.cat(cs["want_w"])]
            errs[name][f"err wgrad {cname}"] = max(map(_rel, got_w, want_w))
            if dgrad is not None:
                errs[name][f"err dgrad {cname}"] = max(
                    _rel(a, w_) for a, w_ in zip(d_out, cs["want_d"], strict=True))
    _report(libs, ptxas, timed, errs)
    return 0


K2BWD16_REPEATS = 2  # calls compared bit for bit


def _time_k2bwdbf16(libs, ptxas) -> int:
    """The bf16 K2 / K3 backward of every source at each K2 / K3 case of
    chip_smoke.py's phase 16.1, in its pieces: wgrad (mc_conv_wgrad_bf16),
    dgrad (mc_conv_dgrad_bf16), each with its fixed-order reduce, the reduces
    alone, and the dx pass; the case's whole backward against the bf16 plain
    version and for the same bits on a repeat. A source that exports
    mc_conv_bwd_bf16_plan (this package's) runs its dx pass as the kernel
    mc_gn_dx_bf16 and K3's up-fold dgrad to the low-res da; one without it
    (an earlier commit's) is called through its own interface, with its dx
    pass, K3's row fold and low-res tail in PyTorch as its wrapper ran them.
    The reduces of an earlier source are timed on the package's mc_colsum
    with that source's scratch shapes."""
    from m_cedm_tpu_torch.kernels import fused_norm_conv as fnc
    from m_cedm_tpu_torch.kernels.fused_norm import (channel_stats_plain, dx_from_da,
                                                     group_mean_rstd_from_sums)
    from m_cedm_tpu_torch.models.layers import adm_groups

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    b, res, ch, eps = K2_B, K2_RES, K2_CH, 1e-5
    bf = torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pkg = libs["package"][0]
    pkg.mc_colsum.argtypes = [P, P, I, I, I, P]
    new_if = {}
    for name, (lib, _) in libs.items():
        new_if[name] = hasattr(lib, "mc_conv_bwd_bf16_plan")
        lib.mc_conv_dgrad_bf16.argtypes = [P] * 10 + [I] * 6 + [F, I, P]
        lib.mc_conv_wgrad_bf16.argtypes = [P] * 8 + [I] * 6 + [F] + [I] * 5 + [P]
        if new_if[name]:
            lib.mc_conv_bwd_bf16_plan.argtypes = [I] * 8 + [P]
            lib.mc_gn_dx_bf16.argtypes = [P] * 7 + [I] * 4 + [F, I, P]
            lib.mc_conv_dgrad_bf16_reduce.argtypes = [P, P, I, I, I, I, P]
        else:
            lib.mc_conv_wgrad_runs.argtypes = [I] * 8
            lib.mc_conv_bwd_tiles.argtypes = [I] * 3

    def rnd(*shape, scale=1.0, shift=0.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)

    def conv_w(ci, co):
        return rnd(3, 3, ci, co, scale=(9 * ci) ** -0.5)

    def rc_ok(rc):
        if rc:
            raise RuntimeError(f"launch failed with cudaError {rc}")

    cases = {}

    def case(name, x, o, act, up=False, skip=None, need_da=True):
        """x the conv input (K3: low-res), o output channels; skip: the
        projection's residual (its one-tap wgrad runs beside)."""
        bb, hin, win, c = x.shape
        h, wd = (2 * hin, 2 * win) if up else (hin, win)
        g = rnd(bb, h, wd, o)
        w = conv_w(c, o)
        groups = adm_groups(c) if act else 0
        gamma, beta = ((rnd(bb, c, scale=0.3, shift=1.0, dtype=torch.float32),
                        rnd(bb, c, scale=0.3, dtype=torch.float32)) if act else (None, None))
        stats = channel_stats_plain(x.reshape(bb, -1, c)) if act else None
        with torch.no_grad():
            if up:
                want = fnc.gn_silu_up_conv_bwd_plain(g, x, gamma, beta, w, groups, eps,
                                                     stats=stats)
            else:
                want = fnc.gn_silu_conv_bwd_plain(g, x, gamma, beta, w, groups, eps,
                                                  stats=stats)[:5]
                if not need_da:
                    want = (None, None, None) + want[3:]
            want = list(want)
            if skip is not None:
                want.append(torch.einsum("bhwr,bhwo->ro", skip.float(), g.float()))
        cases[name] = dict(x=x, g=g, w=w, gamma=gamma, beta=beta, stats=stats, act=act,
                           up=up, skip=skip, need_da=need_da, groups=max(groups, 1),
                           c=c, o=o, h=h, wd=wd, want=want)

    h = rnd(b, res, res, ch, scale=0.8, shift=0.2)
    xc = rnd(b, res, res, 2 * ch, scale=0.8, shift=0.2)
    xl = rnd(b, res // 2, res // 2, ch, scale=0.8, shift=0.2)
    case("identity tail, chained stats, res 128", h, ch, True)
    case("identity_up, res 128", rnd(b, res, res, ch, scale=0.8, shift=0.2), ch, True)
    case("proj from the 128-channel concat, res 128", h, ch, True, skip=xc)
    case("128-channel decoder conv0, res 128", xc, ch, True)
    case("linear down conv0, res 64", rnd(b, res // 2, res // 2, ch, scale=0.8), ch, False)
    case("conv_in (C 4, wgrad only), res 128", rnd(b, res, res, 4), ch, False,
         need_da=False)
    case("K3 up conv0, res 64 -> 128", xl, ch, True, up=True)

    def pieces(name, lib, cs):
        """{piece: call} and the outputs' getter of one source and case."""
        new = new_if[name]
        x, g, w, c, o = cs["x"], cs["g"], cs["w"], cs["c"], cs["o"]
        bb, hh, ww = g.shape[:3]
        up, act, gr = cs["up"], cs["act"], cs["groups"]
        sums, sumsq = cs["stats"] if act else (None, None)
        pv = [None if t is None else t.data_ptr() for t in (cs["gamma"], cs["beta"], sums,
                                                              sumsq)]
        calls, red = {}, []

        def wgrad_call(xin, taps, bias, cin, a):
            if new:  # persistent blocks: the plan's runs, a scratch row each
                plan = (ctypes.c_int * 5)()
                rc_ok(lib.mc_conv_bwd_bf16_plan(1, int(up), bb, hh, ww, cin, o, taps, plan))
                runs = rows = plan[4]
            else:  # runs per image, a scratch row each
                runs = lib.mc_conv_wgrad_runs(bb, hh, ww, cin, o, taps, int(up),
                                              fnc._BLOCKS_PER_SM * sms)
                rows = bb * runs
            k = taps * cin * o + (o if bias else 0)
            dwb = g.new_empty(k, dtype=torch.float32)
            part = g.new_empty(rows, k, dtype=torch.float32)
            p_ = pv if a else [None] * 4

            def call():
                rc_ok(lib.mc_conv_wgrad_bf16(xin.data_ptr(), g.data_ptr(), *p_,
                                             dwb.data_ptr(), part.data_ptr(), bb, hh, ww,
                                             cin, o, gr, eps, int(a), taps, int(up),
                                             int(bias), runs, stream))
            red.append(lambda: rc_ok(pkg.mc_colsum(part.data_ptr(), dwb.data_ptr(), rows, k,
                                                   1, stream)))
            return call, dwb

        wcall, dwb = wgrad_call(x, 9, True, c, act)
        calls["wgrad"] = wcall
        outs = {"dwb": dwb}
        if cs["skip"] is not None:
            scall, dskw = wgrad_call(cs["skip"], 1, False, cs["skip"].shape[-1], False)
            calls["wgrad, one tap (projection)"] = scall
            outs["dskw"] = dskw
        if cs["need_da"]:
            mode = 2 if up else int(act)
            dstats = g.new_empty(2, bb, c, dtype=torch.float32)
            xs = [x.data_ptr()] + pv if act else [None] * 5
            if new:
                plan = (ctypes.c_int * 5)()
                rc_ok(lib.mc_conv_bwd_bf16_plan(0, int(up), bb, hh, ww, c, o, 9, plan))
                gx = plan[4]
                part = g.new_empty(2, bb, gx, c, dtype=torch.float32)
                da = (x.new_empty(x.shape, dtype=torch.float32) if up
                      else torch.empty_like(x))
                per_img = -(-hh // plan[0]) * -(-ww // 16)

                def dcall():
                    rc_ok(lib.mc_conv_dgrad_bf16(g.data_ptr(), w.data_ptr(), *xs,
                                                 da.data_ptr(), dstats.data_ptr(),
                                                 part.data_ptr(), bb, hh, ww, c, o, gr, eps,
                                                 mode, stream))
                calls["dgrad"] = dcall
                dx = None
                if act:
                    red.append(lambda: rc_ok(lib.mc_conv_dgrad_bf16_reduce(
                        part.data_ptr(), dstats.data_ptr(), bb, c, gx, per_img, stream)))
                    dx = torch.empty_like(x)

                    def xcall():
                        rc_ok(lib.mc_gn_dx_bf16(x.data_ptr(), da.data_ptr(), pv[0],
                                                dstats.data_ptr(), pv[2], pv[3],
                                                dx.data_ptr(), bb, x.shape[1] * x.shape[2],
                                                c, gr, eps, int(up), stream))
                    calls["dx pass"] = xcall
            else:
                tiles = lib.mc_conv_bwd_tiles(hh, ww, 0)
                part = g.new_empty(2, bb, tiles, c, dtype=torch.float32)
                da = (g.new_empty(bb, hh, ww // 2, c, dtype=torch.float32) if up
                      else torch.empty_like(x))
                if up:  # the earlier K3 dgrad takes no x
                    xs = [None] * 5

                def dcall():
                    rc_ok(lib.mc_conv_dgrad_bf16(g.data_ptr(), w.data_ptr(), *xs,
                                                 da.data_ptr(), dstats.data_ptr(),
                                                 part.data_ptr(), bb, hh, ww, c, o, gr, eps,
                                                 mode, stream))
                if mode == 1:
                    red.append(lambda: rc_ok(pkg.mc_colsum(part.data_ptr(),
                                                           dstats.data_ptr(), tiles, c,
                                                           2 * bb, stream)))
                dx = None
                calls["dgrad"] = dcall
            outs.update(da=da, dstats=dstats)
            if act:
                hin, win = x.shape[1:3]
                mean, rstd = group_mean_rstd_from_sums(sums, sumsq, hin * win, gr, eps)
                gam, bet = cs["gamma"], cs["beta"]

                def torch_dx():
                    if up and not new:  # the row fold and the low-res tail
                        ds_low = da.reshape(bb, hin, 2, win, c).sum(dim=2)
                        dx_, dg_, db_ = fnc._up_tail_bwd(ds_low, x, gam, bet, mean, rstd, gr)
                        dstats[0].copy_(dg_)
                        dstats[1].copy_(db_)
                        return dx_.to(bf)
                    return dx_from_da(x, da, gam, dstats[0], dstats[1], mean, rstd,
                                      gr).to(bf)
                calls["dx pass, PyTorch (parent style)"] = torch_dx
                outs["dx"] = dx
        parts = list(calls.items())
        calls["reduces alone"] = lambda: [f() for f in red]

        def whole():
            outs["dx_torch"] = None
            for key, fn_ in parts:
                if key == "dx pass, PyTorch (parent style)":
                    if outs.get("dx") is None:
                        outs["dx_torch"] = fn_()
                    continue
                fn_()
        calls["whole backward"] = whole

        def result():
            whole()
            dx = outs.get("dx") if outs.get("dx") is not None else outs.get("dx_torch")
            nw = 9 * c * o
            got = [dx, *(outs["dstats"] if "dstats" in outs and act else (None, None)),
                   outs["dwb"][:nw].view(3, 3, c, o), outs["dwb"][nw:]]
            if not cs["need_da"]:
                got[0] = None
            elif not act:
                got[0] = outs["da"]
            if "dskw" in outs:
                got.append(outs["dskw"].view(-1, o))
            return got
        return calls, result

    def bf16_err(got, want):
        err = (got.double() - want.double()).abs()
        scale = max(float(want.double().abs().max()), 1e-30)
        return float(err.max()) / scale, float(err.mean()) / scale

    calls, errs = {}, {}
    for name, (lib, _) in libs.items():
        calls[name], errs[name] = {}, {}
        for cname, cs in cases.items():
            pc, result = pieces(name, lib, cs)
            for piece, fn_ in pc.items():
                calls[name][f"{piece}: {cname}"] = fn_
            runs = []
            for _ in range(K2BWD16_REPEATS):
                got = [None if t is None else t.clone() for t in result()]
                torch.cuda.synchronize()
                runs.append(got)
            rec = {}
            for i, (a, e) in enumerate(zip(runs[0], cs["want"])):
                if a is None or e is None:
                    continue
                mx, mean = bf16_err(a, e)
                rec[f"out {i}"] = {"max": mx, "mean": mean, "dtype": str(a.dtype)[6:]}
            rec["repeat_bitwise"] = all(
                a is None or torch.equal(a, r) for a, r in zip(runs[0][1:], runs[1][1:]))
            errs[name][f"err {cname}"] = rec
    _report(libs, ptxas, calls, errs)
    return 0


def _time_k5(libs, ptxas) -> int:
    """mc_kv_dots of every source at BH 16 and 64, with the wrapper's split
    rule and with two blocks per SM, checked against float64, then timed."""
    import math

    from m_cedm_tpu_torch.kernels import linear_attention as la

    dev = torch.device("cuda")
    rs = np.random.RandomState(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = {}
    for bh in K6_BH:
        k = torch.from_numpy(rs.randn(bh, K6_N, K6_W).astype(np.float32)).to(dev)
        v = torch.from_numpy(rs.randn(bh, K6_N, K6_W).astype(np.float32)).to(dev)
        want = k.double().transpose(1, 2) @ v.double()
        for rule, splits in (("one per SM", la._splits(bh, K6_N, dev)),
                             ("two per SM", max(1, min(2 * sms // bh, K6_N // 128)))):
            rows = math.ceil(math.ceil(K6_N / splits) / la._CHUNK) * la._CHUNK
            cases[f"bh {bh}, {splits} splits ({rule})"] = (
                k, v, torch.empty(bh, K6_W, K6_W, device=dev),
                torch.empty(bh, splits, K6_W, K6_W, device=dev), bh, splits, rows, want)

    def call(lib, c):
        k, v, out, part, bh, splits, rows, _ = c
        return lambda: lib.mc_kv_dots(k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      part.data_ptr(), bh, K6_N, K6_W, K6_W, splits,
                                      rows, stream)

    calls, errs = {}, {}
    for name, (lib, _) in libs.items():
        calls[name] = {case: call(lib, c) for case, c in cases.items()}
        errs[name] = {}
        for case, c in cases.items():
            if calls[name][case]():
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            errs[name][f"err {case}"] = _rel(c[2], c[7])
    _report(libs, ptxas, calls, errs)
    return 0


# the bf16 K5 / K6 cases (BH, N) at D = E = 128: the OFormer's two batches
# of heads at its N, and at the time prediction's
LINEAR_BF16_CASES = ((16, 16384), (64, 16384), (16, 8192), (64, 8192))


def _bf16_err(got, want):
    err = (got.double() - want.double()).abs()
    scale = max(float(want.double().abs().max()), 1e-30)
    return float(err.max()) / scale, float(err.mean()) / scale


def _linear_bf16_info(libs, kind: str) -> None:
    """Each source's SASS counts of its `kind` kernels and each case's bytes
    bound (bf16 operands read once, the output written once)."""
    for name, (_, so) in libs.items():
        print(json.dumps({"source": name, "sass": _build.sass_counts(so, kind)}), flush=True)
    out_bytes = {"kv_dots": lambda bh, n: 4 * bh * K6_W * K6_W,
                 "apply_dots": lambda bh, n: 2 * bh * n * K6_W}[kind]
    print(json.dumps({f"{kind} bf16 bound_ms": {
        f"BH {bh}, N {n}": (2 * bh * n * K6_W * (2 if kind == "kv_dots" else 1)
                            + out_bytes(bh, n)) / 3.35e12 * 1e3
        for bh, n in LINEAR_BF16_CASES}}), flush=True)


def _checked(name):
    def check(rc):
        if rc:
            raise RuntimeError(f"{name}: launch failed with cudaError {rc}")
    return check


def _time_k5bf16(libs, ptxas) -> int:
    """The bf16 K5 of every source at LINEAR_BF16_CASES: this package's on
    its TMA route at every cluster size (the wrapper's rule marked), the
    parent's through its own interface; each output against the plain
    version and for the same bits on a repeat; bf16 torch.bmm and its
    out_dtype=float32 form beside; on the card's clock."""
    import math

    from m_cedm_tpu_torch.kernels import linear_attention as la

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    d = e = K6_W
    _linear_bf16_info(libs, "kv_dots")
    active = {}
    for name, (lib, _) in libs.items():
        if hasattr(lib, "mc_kv_dots_bf16_tma"):
            lib.mc_kv_dots_bf16_tma.argtypes = [P] * 3 + [I] * 5 + [P]
            lib.mc_kv_dots_bf16_tma_clusters.argtypes = [I, P]
            got = ctypes.c_int(0)
            active[name] = []
            for c in range(1, la.KV_CLUSTER_MAX + 1):
                _checked(name)(lib.mc_kv_dots_bf16_tma_clusters(c, ctypes.addressof(got)))
                active[name].append(got.value)
    print(json.dumps({"k5bf16 active clusters of 1 to 8 blocks": active}), flush=True)
    cases = {}
    for bh, n in LINEAR_BF16_CASES:
        k, v = (torch.randn(bh, n, w, generator=gen, device=dev).to(torch.bfloat16)
                for w in (d, e))
        cases[(bh, n)] = (k, v, la.kv_dots_plain(k, v), torch.empty(bh, d, e, device=dev))
    calls, errs = {}, {}
    for name, (lib, _) in libs.items():
        calls[name], errs[name] = {}, {}
        check = _checked(name)
        for (bh, n), (k, v, want, out) in cases.items():
            case = f"BH {bh}, N {n}"
            runs = {}
            if name in active:
                rule = la.kv_cluster(bh, n, active[name])
                for c in range(1, la.KV_CLUSTER_MAX + 1):
                    runs[f"{case}, cluster {c}{' (rule)' if c == rule else ''}"] = (
                        lambda k=k, v=v, out=out, bh=bh, n=n, c=c, lib=lib, check=check: check(
                            lib.mc_kv_dots_bf16_tma(k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                                    bh, n, d, e, c, stream)))
            else:
                splits = max(1, min(sms // bh, math.ceil(n / 128)))
                rows = math.ceil(math.ceil(n / splits) / la._CHUNK) * la._CHUNK
                part = torch.empty(bh, splits, d, e, device=dev)
                runs[f"{case}, splits {splits}"] = (
                    lambda k=k, v=v, out=out, part=part, bh=bh, n=n, s=splits, r=rows, lib=lib,
                    check=check: check(
                        lib.mc_kv_dots_bf16(k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                            part.data_ptr(), bh, n, d, e, s, r, stream)))
            for key, run in runs.items():
                run()
                torch.cuda.synchronize()
                first = out.clone()
                run()
                torch.cuda.synchronize()
                errs[name][f"err {key}"] = _rel(out, want.double())
                errs[name][f"same bits {key}"] = bool(torch.equal(first, out))
                calls[name][key] = run
            if name == "package":
                calls[name][f"library bf16 torch.bmm (bf16 out) {case}"] = (
                    lambda k=k, v=v: torch.bmm(k.transpose(1, 2), v))
                try:
                    torch.bmm(k.transpose(1, 2), v, out_dtype=torch.float32)
                    calls[name][f"library torch.bmm out_dtype float32 {case}"] = (
                        lambda k=k, v=v: torch.bmm(k.transpose(1, 2), v,
                                                   out_dtype=torch.float32))
                except (TypeError, RuntimeError) as err:
                    print(json.dumps({"torch.bmm out_dtype float32": repr(err)}), flush=True)
    _report(libs, ptxas, calls, errs, timer=lambda fn_: device_ms(fn_, repeats=5))
    return 0


def _time_k6bf16(libs, ptxas) -> int:
    """The bf16 K6 of every source at LINEAR_BF16_CASES with an fp32 and a
    bf16 factor: this package's on its TMA route, the parent's through
    mc_apply_dots_bf16 (the same arguments); each output against the bf16
    plain version and for the same bits on a repeat; bf16 torch.bmm beside;
    on the card's clock."""
    from m_cedm_tpu_torch.kernels import linear_attention as la

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    d = e = K6_W
    _linear_bf16_info(libs, "apply_dots")
    for lib, _ in libs.values():
        if hasattr(lib, "mc_apply_dots_bf16_tma"):
            lib.mc_apply_dots_bf16_tma.argtypes = [P, P, I, P] + [I] * 4 + [P]
    cases = {}
    for bh, n in LINEAR_BF16_CASES:
        q = torch.randn(bh, n, d, generator=gen, device=dev).to(torch.bfloat16)
        f32 = torch.randn(bh, d, e, generator=gen, device=dev) / d ** 0.5
        for label, f in (("fp32 factor", f32), ("bf16 factor", f32.bfloat16())):
            cases[(bh, n, label)] = (q, f, la.apply_dots_plain(q, f),
                                     torch.empty(bh, n, e, device=dev, dtype=torch.bfloat16))
    calls, errs = {}, {}
    for name, (lib, _) in libs.items():
        calls[name], errs[name] = {}, {}
        check = _checked(name)
        fn = getattr(lib, "mc_apply_dots_bf16_tma", lib.mc_apply_dots_bf16)
        for (bh, n, label), (q, f, want, out) in cases.items():
            key = f"BH {bh}, N {n}, {label}"

            def run(q=q, f=f, out=out, bh=bh, n=n, fn=fn, check=check):
                check(fn(q.data_ptr(), f.data_ptr(), int(f.dtype == torch.bfloat16),
                         out.data_ptr(), bh, n, d, e, stream))
            run()
            torch.cuda.synchronize()
            first = out.clone()
            run()
            torch.cuda.synchronize()
            errs[name][f"err {key}"] = _bf16_err(out, want)
            errs[name][f"same bits {key}"] = bool(torch.equal(first, out))
            calls[name][key] = run
            if name == "package" and label == "bf16 factor":
                calls[name][f"library bf16 torch.bmm BH {bh}, N {n}"] = (
                    lambda q=q, f=f: torch.bmm(q, f))
    _report(libs, ptxas, calls, errs, timer=lambda fn_: device_ms(fn_, repeats=5))
    return 0


def _time_k7(libs, ptxas) -> int:
    """mc_unet_block of every source at phase 9's modes (and the identity
    block at res 64 and 32), checked against the plain block in float64,
    then timed; the two-kernel path's time on the same inputs beside."""
    import math

    from m_cedm_tpu_torch.kernels import fused_block as fb
    from m_cedm_tpu_torch.kernels import fused_norm_conv as fnc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    b, res, ch = K2_B, K2_RES, K2_CH

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + shift

    def empty(*shape):
        return torch.empty(shape, device=dev)

    def two_kernel(args, groups, kw, t):
        """K2 conv0 (K3 for an up block) emitting its statistics, then the K2
        tail, as the U-Net's per-conv path runs the block."""
        x, g0, b0, w0, bias0, g1, b1, w1, bias1 = args
        xin = torch.cat([x, kw["x2"]], -1) if kw["x2"] is not None else x
        stats = (t["sums0"], t["sumsq0"])
        if kw["up"]:
            h, hs = fnc.gn_silu_up_conv(xin, g0, b0, w0, bias0, groups[0], 1e-5,
                                        stats=stats, emit_stats=True)
            tail = dict(residual=xin, res_up=True)
        else:
            h, hs = fnc.gn_silu_conv(xin, g0, b0, w0, bias0, groups[0], 1e-5,
                                     stats=stats, emit_stats=True)
            tail = dict(residual=xin, skip_w=kw["skip_w"], skip_b=kw["skip_b"])
        return fnc.gn_silu_conv(h, g1, b1, w1, bias1, groups[1], 1e-5, stats=hs,
                                emit_stats=kw["emit_stats"], **tail)

    cases = {}

    def k7(name, bb, hin, win, c1, c2, o, up=False, proj=False, emit=False):
        c = c1 + c2
        h, w = (2 * hin, 2 * win) if up else (hin, win)
        t = dict(x=rnd(bb, hin, win, c1, scale=0.8, shift=0.2),
                 x2=rnd(bb, hin, win, c2, scale=0.8, shift=0.2) if c2 else None,
                 g0=rnd(bb, c, scale=0.3, shift=1.0), b0=rnd(bb, c, scale=0.3),
                 w0=rnd(3, 3, c, o, scale=1.0 / math.sqrt(9 * c)), bias0=rnd(o, scale=0.3),
                 g1=rnd(bb, o, scale=0.3, shift=1.0), b1=rnd(bb, o, scale=0.3),
                 w1=rnd(3, 3, o, o, scale=1.0 / math.sqrt(9 * o)), bias1=rnd(o, scale=0.3),
                 skip_w=rnd(c, o, scale=1.0 / math.sqrt(c)) if proj else None,
                 skip_b=rnd(o, scale=0.3) if proj else None)
        xin = torch.cat([t["x"]] + ([t["x2"]] if c2 else []), -1)
        t["sums0"], t["sumsq0"] = xin.sum(dim=(1, 2)), (xin * xin).sum(dim=(1, 2))
        tiles = math.ceil(h / fb._TH) * math.ceil(w / fb._TW)
        t.update(ws=empty(bb, h, w, o), part_s=empty(bb, tiles, o),
                 part_ss=empty(bb, tiles, o), sums1=empty(bb, o), sumsq1=empty(bb, o),
                 out=empty(bb, h, w, o), osums=empty(bb, o) if emit else None,
                 osumsq=empty(bb, o) if emit else None)
        args = [t[k] for k in ("x", "g0", "b0", "w0", "bias0", "g1", "b1", "w1", "bias1")]
        groups = (32 if c % 32 == 0 else 1, 32 if o % 32 == 0 else 1)
        kw = dict(x2=t["x2"], skip_w=t["skip_w"], skip_b=t["skip_b"], emit_stats=emit,
                  up=up)
        want = fb.fused_unet_block_plain(
            *[a.double() for a in args], *groups, 1e-5,
            **{k: (v.double() if torch.is_tensor(v) else v) for k, v in kw.items()})
        cases[name] = dict(t=t, dims=(bb, h, w, c1, c2, o, *groups), up=up,
                           want=_leaves(want),
                           two=lambda: two_kernel(args, groups, kw, t))

    k7(f"identity, res {res}, chained stats, emit", b, res, res, ch, 0, ch, emit=True)
    k7(f"dual + 1x1 projection ({ch} + {ch} -> {ch}), res {res}", b, res, res, ch, ch,
       ch, proj=True)
    k7(f"up, identity ({res // 2} -> {res}), chained stats, emit", b, res // 2, res // 2,
       ch, 0, ch, up=True, emit=True)
    k7("ragged: (1, 7, 19), 128 + 128 -> 128, projection, emit", 1, 7, 19, 128, 128, 128,
       proj=True, emit=True)
    for r in (res // 2, res // 4):
        k7(f"identity, res {r}, chained stats, emit", b, r, r, ch, 0, ch, emit=True)

    def call(lib, c):
        t = c["t"]
        p = [None if t[k] is None else t[k].data_ptr() for k in (
            "x", "x2", "g0", "b0", "sums0", "sumsq0", "w0", "bias0", "g1", "b1", "w1",
            "bias1", "skip_w", "skip_b", "ws", "part_s", "part_ss", "sums1", "sumsq1",
            "out", "osums", "osumsq")]

        def fn():
            rc = lib.mc_unet_block(*p, *c["dims"], 1e-5, int(c["up"]), stream)
            if rc:
                raise RuntimeError(f"launch failed with cudaError {rc}")
        return fn

    print(json.dumps({"two_kernel_path": {f"ms {case}": _cuda_ms(c["two"])
                                          for case, c in cases.items()},
                      "items_grid": {case: fb.grid(c["dims"][0], c["dims"][1],
                                                   c["dims"][2], c["dims"][5], c["up"])
                                     for case, c in cases.items()}}), flush=True)
    calls, errs = {}, {}
    for name, (lib, _) in libs.items():
        calls[name] = {case: call(lib, c) for case, c in cases.items()}
        errs[name] = {}
        for case, c in cases.items():
            calls[name][case]()
            torch.cuda.synchronize()
            t = c["t"]
            got = [t["out"]] + ([t["osums"], t["osumsq"]] if t["osums"] is not None else [])
            errs[name][f"err {case}"] = max(_rel(a, w) for a, w in zip(got, c["want"],
                                                                     strict=True))
    _report(libs, ptxas, calls, errs)
    return 0


def k7_bf16_cases(device, b: int, res: int, ch: int, seed: int) -> dict:
    """The bf16 K7's cases at the flagship's widths, each (args, kw) of
    `fused_unet_block` with chained fp32 statistics of its bf16 input: every
    launch kind of the flagship's forward (the identity block at res, res /
    2 and res / 4, the decoder's ch + ch -> ch block with its 1x1
    projection at the same three, the up blocks from res / 2 to res and
    from res / 4 to res / 2; all emitting statistics; K7_BF16_PER_FORWARD
    counts them), then the ragged 128 + 128 -> 128 case (its weights
    stream) and the identity block at width 36, which takes the kept
    cp.async route (36 is not a multiple of 8). Shared with chip_smoke.py."""
    import math

    from m_cedm_tpu_torch.models.layers import adm_groups

    bf = torch.bfloat16
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0, shift=0.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=device) * scale + shift).to(dtype)

    def block(bb, h, w, c1, c2, o, up=False, proj=False):
        c, f32 = c1 + c2, torch.float32
        args = [rnd(bb, h, w, c1, scale=0.8, shift=0.2),
                rnd(bb, c, scale=0.3, shift=1.0, dtype=f32), rnd(bb, c, scale=0.3, dtype=f32),
                rnd(3, 3, c, o, scale=1.0 / math.sqrt(9 * c)), rnd(o, scale=0.3, dtype=f32),
                rnd(bb, o, scale=0.3, shift=1.0, dtype=f32), rnd(bb, o, scale=0.3, dtype=f32),
                rnd(3, 3, o, o, scale=1.0 / math.sqrt(9 * o)), rnd(o, scale=0.3, dtype=f32),
                adm_groups(c), adm_groups(o), 1e-5]
        kw = dict(emit_stats=True, up=up)
        if c2:
            kw["x2"] = rnd(bb, h, w, c2, scale=0.8, shift=0.2)
        if proj:
            kw["skip_w"] = rnd(c, o, scale=1.0 / math.sqrt(c))
            kw["skip_b"] = rnd(o, scale=0.3, dtype=f32)
        xin = torch.cat([args[0]] + ([kw["x2"]] if c2 else []), -1).double()
        kw["stats"] = (xin.sum(dim=(1, 2)).float(), (xin * xin).sum(dim=(1, 2)).float())
        return args, kw

    cases = {f"identity, res {r}, chained stats, emit": block(b, r, r, ch, 0, ch)
             for r in (res, res // 2, res // 4)}
    for r in (res, res // 2, res // 4):
        cases[f"dual + 1x1 projection ({ch} + {ch} -> {ch}), res {r}, chained stats, "
              "emit"] = block(b, r, r, ch, ch, ch, proj=True)
    for r in (res, res // 2):
        lo = r // 2
        cases[f"up, identity ({lo}x{lo} -> {r}x{r}), chained stats, emit"] = block(
            b, lo, lo, ch, 0, ch, up=True)
    cases["ragged: (1, 7, 19), 128 + 128 -> 128, projection, chained stats, emit"] = block(
        1, 7, 19, 128, 128, 128, proj=True)
    cases[f"width 36 (the kept route), identity, res {res // 4}, chained stats, emit"] = block(
        b, res // 4, res // 4, 36, 0, 36)
    return cases


def k7_bf16_per_forward(res: int, ch: int) -> dict:
    """K7 launches of one flagship U-Net forward (ch_mult (1, 1, 1), one res
    block a level, mega=True) by k7_bf16_cases' name: the encoder's and the
    middle's identity blocks (one at res and res / 2, three at res / 4),
    the decoder's two dual blocks a level, its two up blocks."""
    lo = res // 4
    per = {f"identity, res {res}, chained stats, emit": 1,
           f"identity, res {res // 2}, chained stats, emit": 1,
           f"identity, res {lo}, chained stats, emit": 3}
    for r in (res, res // 2, lo):
        per[f"dual + 1x1 projection ({ch} + {ch} -> {ch}), res {r}, chained stats, emit"] = 2
    for r in (res, res // 2):
        per[f"up, identity ({r // 2}x{r // 2} -> {r}x{r}), chained stats, emit"] = 1
    return per


def _time_k7bf16(libs, ptxas) -> int:
    """mc_unet_block_bf16 of every source at phase 15.6's cases, checked
    against the bf16 plain version and for the same bits on a repeat, then
    timed on the card's clock; the bf16 two-kernel path beside."""
    import math

    from m_cedm_tpu_torch.kernels import fused_block as fb
    from m_cedm_tpu_torch.kernels import fused_norm_conv as fnc
    from m_cedm_tpu_torch.kernels._timing import device_ms

    def two_kernel_block(*a, x2=None, skip_w=None, skip_b=None, stats=None,
                         emit_stats=False, up=False):
        """The per-conv path of one block: K2 conv0 (K3 for an up block)
        emitting its statistics, then the K2 tail, through the wrappers."""
        return fb._composition(fnc.gn_silu_conv, fnc.gn_silu_up_conv, *a, x2, skip_w,
                               skip_b, emit_stats, up, stats=stats, chain=True)

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    cases = {}
    for name, (args, kw) in k7_bf16_cases(dev, K2_B, K2_RES, K2_CH, seed=0).items():
        x, x2 = args[0], kw.get("x2")
        c1, c2, o = x.shape[-1], x2.shape[-1] if x2 is not None else 0, args[3].shape[-1]
        bb, h, w = x.shape[:3]
        h, w = (2 * h, 2 * w) if kw["up"] else (h, w)
        emit = kw["emit_stats"]
        with torch.no_grad():
            want = _leaves(fb.fused_unet_block_plain(*args, **kw))
        tiles = math.ceil(h / fb._TH) * math.ceil(w / fb._TW)

        def empty(*shape, dtype=torch.float32):
            return torch.empty(shape, device=dev, dtype=dtype)

        t = dict(zip(("x", "g0", "b0", "w0", "bias0", "g1", "b1", "w1", "bias1"), args[:9]),
                 x2=x2, skip_w=kw.get("skip_w"), skip_b=kw.get("skip_b"),
                 sums0=kw["stats"][0], sumsq0=kw["stats"][1],
                 ws=empty(bb, h, w, o, dtype=torch.bfloat16), part_s=empty(bb, tiles, o),
                 part_ss=empty(bb, tiles, o), sums1=empty(bb, o), sumsq1=empty(bb, o),
                 out=empty(bb, h, w, o, dtype=torch.bfloat16),
                 osums=empty(bb, o) if emit else None, osumsq=empty(bb, o) if emit else None)
        cases[name] = dict(t=t, dims=(bb, h, w, c1, c2, o, args[9], args[10]), up=kw["up"],
                           plan_dims=(bb, h, w, c1, c2, o, int(kw["up"]),
                                      int(kw.get("skip_w") is not None)),
                           want=want, args=args, kw=kw,
                           two=lambda a=args, k=kw: two_kernel_block(*a, **k))

    def call(lib, c):
        t = c["t"]
        p = [None if t[k] is None else t[k].data_ptr() for k in (
            "x", "x2", "g0", "b0", "sums0", "sumsq0", "w0", "bias0", "g1", "b1", "w1",
            "bias1", "skip_w", "skip_b", "ws", "part_s", "part_ss", "sums1", "sumsq1",
            "out", "osums", "osumsq")]

        def fn():
            rc = lib.mc_unet_block_bf16(*p, *c["dims"], 1e-5, int(c["up"]), stream)
            if rc:
                raise RuntimeError(f"launch failed with cudaError {rc}")
        return fn

    def plan(lib, c):
        """the source's plan (a source before the TMA route gives its first
        seven fields)"""
        out = (ctypes.c_int * 10)()
        rc = lib.mc_unet_block_bf16_plan(*c["plan_dims"], out)
        return dict(zip(("resident0", "resident1", "smem", "blocks_per_sm", "sms", "blocks",
                         "tile_rows", "route_tma", "stages", "consumer_warpgroups"),
                        list(out))) if rc == 0 else {"error": rc}

    def host_us(fn, n=50):
        """the C entry's host time a call (the launch enqueued, not waited)"""
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return sorted(times)[n // 2] * 1e6

    def bf16_err(got, want):
        err = (got.double() - want.double()).abs()
        scale = max(float(want.double().abs().max()), 1e-30)
        return float(err.max()) / scale, float(err.mean()) / scale

    def timer(fn):
        return device_ms(fn, 10, 5)

    def errors(got, want):
        """max and mean of the output, max of each statistic, of scale"""
        rec = dict(zip(("max", "mean"), bf16_err(got[0], want[0])))
        if len(got) == 3:
            rec.update(osums_max=bf16_err(got[1], want[1])[0],
                       osumsq_max=bf16_err(got[2], want[2])[0])
        return rec

    two = {}
    for case, c in cases.items():
        with torch.no_grad():
            two[f"err {case}"] = errors(_leaves(c["two"]()), c["want"])
        two[f"ms {case}"] = timer(c["two"])
        # context: the bf16 function's own distance from the unrounded block
        # (float64, the same inputs)
        args64 = [a.double() if torch.is_tensor(a) else a for a in c["args"]]
        kw64 = {k: v.double() if torch.is_tensor(v) else v for k, v in c["kw"].items()
                if k != "stats"}
        with torch.no_grad():
            two[f"bf16 plain vs float64 {case}"] = errors(
                c["want"], _leaves(fb.fused_unet_block_plain(*args64, **kw64)))
    print(json.dumps({"two_kernel_path_bf16": two}), flush=True)
    calls, errs = {}, {}
    for name, (lib, _) in libs.items():
        calls[name] = {case: call(lib, c) for case, c in cases.items()}
        errs[name] = {}
        for case, c in cases.items():
            t = c["t"]
            outs = ("out", "osums", "osumsq") if t["osums"] is not None else ("out",)
            calls[name][case]()
            torch.cuda.synchronize()
            first = [t[k].clone() for k in outs]
            calls[name][case]()
            torch.cuda.synchronize()
            errs[name][f"err {case}"] = {
                **errors(first, c["want"]), "plan": plan(lib, c),
                "host_us": host_us(calls[name][case]),
                "same_bits_on_repeat": all(torch.equal(a, t[k]) for a, k in
                                           zip(first, outs))}
    # two rounds of opposite order, each source's cases timed, and a
    # forward's K7 time (each launch kind's time times its launches)
    per = k7_bf16_per_forward(K2_RES, K2_CH)
    print(json.dumps({"per_forward": per, "two_kernel_ms_per_forward": sum(
        n * two[f"ms {case}"] for case, n in per.items())}), flush=True)
    names = list(libs)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            ms = {f"ms {case}": timer(fn) for case, fn in calls[name].items()}
            print(json.dumps({"source": name, "round": rnd, **ms, "ms_per_forward": sum(
                n * ms[f"ms {case}"] for case, n in per.items()), **errs[name],
                "ptxas": ptxas[name]}), flush=True)
    return 0


K1_BWD_RES = (128, 64)


def _time_k1bwd(libs, ptxas) -> int:
    """mc_gn_silu_bwd of every source at the train step's shapes (B 16, C 64,
    16 groups, N = 128^2 and 64^2), checked against float64 and for the same
    bits on a repeat, then timed (the zeroing of its counters, or of the
    parent's atomic outputs, inside the timed call, as the wrapper allocates
    them); each case's bound and, for this package's interface, its plan."""
    from m_cedm_tpu_torch.kernels import fused_norm as fn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b, c, groups, eps = K2_B, K2_CH, 16, 1e-5
    # this package's interface: scratch, counters and the slab plan; the
    # parent's: zeroed dgamma / dbeta that it adds into with atomics
    new_if = {name: hasattr(lib, "mc_gn_silu_bwd_occupancy") for name, (lib, _) in libs.items()}
    for name, (lib, _) in libs.items():
        lib.mc_gn_silu_bwd.argtypes = ([P] * 11 + [I] * 4 + [F, I, I, P] if new_if[name]
                                       else [P] * 9 + [I] * 4 + [F, P])
        if new_if[name]:
            lib.mc_gn_silu_bwd_occupancy.argtypes = [I, I, I] + [P] * 6

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + shift

    cases, info = {}, {}
    for res in K1_BWD_RES:
        n = res * res
        x, g = rnd(b, n, c, scale=0.8, shift=0.2), rnd(b, n, c)
        gamma, beta = rnd(b, c, scale=0.3, shift=1.0), rnd(b, c, scale=0.3)
        sums, sumsq = fn.channel_stats_plain(x)
        mean, rstd = fn.group_mean_rstd_from_sums(sums.double(), sumsq.double(), n,
                                                  groups, eps)
        x64, gm64 = x.double(), gamma.double()
        xhat = (x64 - mean[:, None]) * rstd[:, None]
        dy = g.double() * fn.silu_grad(xhat * gm64[:, None] + beta.double()[:, None])
        dgamma, dbeta = (dy * xhat).sum(dim=1), dy.sum(dim=1)
        want = [fn.dx_from_da(x64, dy, gm64, dgamma, dbeta, mean, rstd, groups),
                dgamma, dbeta]
        case = f"res {res}"
        cases[case] = dict(args=(x, g, gamma, beta, sums, sumsq), n=n, want=want)
        slabs, rows = fn.bwd_plan(n, c, sms)
        info[case] = {"bound_ms": 3 * x.numel() * 4 / 3.35e12 * 1e3,
                      "slabs": slabs, "rows": rows}

    def call(name, lib, cs):
        x, g, gamma, beta, sums, sumsq = cs["args"]
        n = cs["n"]
        dx, dgam, dbet = torch.empty_like(x), x.new_empty(b, c), x.new_empty(b, c)
        ptrs = [t.data_ptr() for t in (x, g, gamma, beta, sums, sumsq, dgam, dbet, dx)]
        if new_if[name]:
            slabs, rows = fn.bwd_plan(n, c, sms)
            scratch = x.new_empty(b * slabs * -(-2 * c // 4) * 4)
            sync = torch.zeros(-(-b // 2) * 2 + 4 * b * groups, device=dev, dtype=torch.int32)

            def run():
                sync.zero_()
                return lib.mc_gn_silu_bwd(*ptrs, scratch.data_ptr(), sync.data_ptr(), b, n,
                                          c, groups, eps, slabs, rows, stream)
        else:
            def run():
                dgam.zero_()
                dbet.zero_()
                return lib.mc_gn_silu_bwd(*ptrs, b, n, c, groups, eps, stream)

        def checked():
            rc = run()
            if rc:
                raise RuntimeError(f"{name}: launch failed with cudaError {rc}")
        return checked, (dx, dgam, dbet)

    for name, (lib, _) in libs.items():
        if new_if[name]:
            for case, cs in cases.items():
                vals = [ctypes.c_int(0) for _ in range(6)]
                rc = lib.mc_gn_silu_bwd_occupancy(
                    c, groups, info[case]["rows"], *[ctypes.addressof(v) for v in vals])
                if rc:
                    raise RuntimeError(f"{name}: occupancy query failed with cudaError {rc}")
                info[case][name] = dict(zip(("stages", "lag", "smem_rows", "smem_bytes",
                                             "per_sm", "sms"), (v.value for v in vals)))
    print(json.dumps({"k1bwd_cases": info}), flush=True)
    calls, errs = {}, {}
    for name, (lib, _) in libs.items():
        calls[name], errs[name] = {}, {}
        for case, cs in cases.items():
            fn_, outs = call(name, lib, cs)
            fn_()
            torch.cuda.synchronize()
            first = [t.clone() for t in outs]
            fn_()
            torch.cuda.synchronize()
            errs[name][f"err {case}"] = max(_rel(a, w) for a, w in zip(outs, cs["want"]))
            errs[name][f"same bits {case}"] = all(torch.equal(a, a2)
                                                  for a, a2 in zip(first, outs))
            calls[name][case] = fn_
    _report(libs, ptxas, calls, errs)
    return 0


# K1's bf16 backward at the train step's shapes (B, N, C, groups): res 128 and
# 64, then the CLI's batch 32 at res 128 as context
K1_BWD_BF16_SHAPES = ((16, 16384, 64, 16), (16, 4096, 64, 16), (32, 16384, 64, 16))


def _host_us(fn, n: int = 50) -> float:
    """The host time of one fn() (its launches enqueued, not waited), the
    median of n calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return sorted(times)[n // 2] * 1e6


def _bf16_max_mean(got, want):
    err = (got.double() - want.double()).abs()
    scale = max(float(want.double().abs().max()), 1e-30)
    return float(err.max()) / scale, float(err.mean()) / scale


def _time_k1bwdbf16(libs, ptxas) -> int:
    """K1's bf16 backward of every source, called directly at
    K1_BWD_BF16_SHAPES: dx held to the bf16 plain version (max and mean of
    scale), dgamma and dbeta to it and to float64 (max of scale), every
    output to its own bits on a repeat; the call as its wrapper makes it
    (the outputs allocated inside the timed call, and for the parent's
    interface its scratch and its zeroed counters) on the card's clock and
    by the host's (`host_us`); each case's plan and bound. A source with
    `mc_gn_silu_bwd_bf16_plan` takes this package's interface (tagged
    exchange words kept from call to call, an epoch a call); one without,
    such as the parent's, its own (per-slab scratch and zeroed counters, the
    slab plan of kernels/fused_norm.py::bwd_plan)."""
    from m_cedm_tpu_torch.kernels import fused_norm as fn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    eps = 1e-5
    new_if = {name: hasattr(lib, "mc_gn_silu_bwd_bf16_plan") for name, (lib, _) in libs.items()}
    for name, (lib, _) in libs.items():
        if new_if[name]:
            lib.mc_gn_silu_bwd_bf16.argtypes = [P] * 10 + [ctypes.c_uint] + [I] * 4 + [F, P]
            lib.mc_gn_silu_bwd_bf16_plan.argtypes = [I] * 4 + [P]
        else:
            lib.mc_gn_silu_bwd_bf16.argtypes = [P] * 11 + [I] * 4 + [F, I, I, P]

    def rnd(*shape, scale=1.0, shift=0.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)

    cases = {}
    for b, n, c, groups in K1_BWD_BF16_SHAPES:
        x, g = rnd(b, n, c, scale=0.8, shift=0.2), rnd(b, n, c)
        gamma = rnd(b, c, scale=0.3, shift=1.0, dtype=torch.float32)
        beta = rnd(b, c, scale=0.3, dtype=torch.float32)
        sums, sumsq = fn.channel_stats_plain(x)
        want = fn.gn_silu_bwd_bf16_plain(g, x, gamma, beta, groups, eps, stats=(sums, sumsq))
        # float64 on the same inputs and statistics: dgamma, dbeta
        mean, rstd = fn.group_mean_rstd_from_sums(sums.double(), sumsq.double(), n, groups, eps)
        xhat = (x.double() - mean[:, None]) * rstd[:, None]
        dy = g.double() * fn.silu_grad(xhat * gamma.double()[:, None] + beta.double()[:, None])
        cases[f"B {b}, N {n}, C {c}"] = dict(
            args=(x, g, gamma, beta, sums, sumsq), dims=(b, n, c, groups), want=want,
            want64=((dy * xhat).sum(dim=1), dy.sum(dim=1)),
            bound_ms=3 * x.numel() * 2 / 3.35e12 * 1e3)

    def plan(lib, dims):
        out = (ctypes.c_longlong * len(fn.BWD_BF16_PLAN_KEYS))()
        rc = lib.mc_gn_silu_bwd_bf16_plan(*dims, out)
        return dict(zip(fn.BWD_BF16_PLAN_KEYS, out)) if rc == 0 else {"error": rc}

    def call(name, lib, cs):
        x, g, gamma, beta, sums, sumsq = cs["args"]
        b, n, c, groups = cs["dims"]
        outs = {}
        if new_if[name]:
            words = plan(lib, cs["dims"])["xchg_words"]
            xchg = torch.zeros(max(words, 1), device=dev, dtype=torch.int64)
            epoch = [0]

            def run():
                dgb = torch.empty((2, b, c), device=dev, dtype=torch.float32)
                dx = torch.empty_like(x)
                epoch[0] += 1
                outs["t"] = (dx, dgb[0], dgb[1])
                return lib.mc_gn_silu_bwd_bf16(
                    x.data_ptr(), g.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                    sums.data_ptr(), sumsq.data_ptr(), dgb[0].data_ptr(), dgb[1].data_ptr(),
                    dx.data_ptr(), xchg.data_ptr() if words else None,
                    epoch[0] if words else 0, b, n, c, groups, eps, stream)
        else:
            slabs, rows = fn.bwd_plan(n, c, sms)

            def run():
                scratch = torch.empty(b * slabs * -(-2 * c // 4) * 4, device=dev)
                sync = torch.zeros(-(-b // 2) * 2 + 4 * b * groups, device=dev,
                                   dtype=torch.int32)
                dgam = torch.empty((b, c), device=dev)
                dbet = torch.empty_like(dgam)
                dx = torch.empty_like(x)
                outs["t"] = (dx, dgam, dbet)
                return lib.mc_gn_silu_bwd_bf16(
                    x.data_ptr(), g.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                    sums.data_ptr(), sumsq.data_ptr(), dgam.data_ptr(), dbet.data_ptr(),
                    dx.data_ptr(), scratch.data_ptr(), sync.data_ptr(), b, n, c, groups, eps,
                    slabs, rows, stream)

        def checked():
            rc = run()
            if rc:
                raise RuntimeError(f"{name}: launch failed with cudaError {rc}")
        return checked, outs

    calls, errs = {}, {}
    for name, (lib, _) in libs.items():
        calls[name], errs[name] = {}, {}
        for case, cs in cases.items():
            fn_, outs = call(name, lib, cs)
            fn_()
            torch.cuda.synchronize()
            first = [t.clone() for t in outs["t"]]
            fn_()
            torch.cuda.synchronize()
            dx_max, dx_mean = _bf16_max_mean(outs["t"][0], cs["want"][0])
            errs[name][f"err {case}"] = {
                "dx_max": dx_max, "dx_mean": dx_mean,
                "dgamma_dbeta_vs_plain": max(_bf16_max_mean(a, w)[0] for a, w in
                                             zip(outs["t"][1:], cs["want"][1:])),
                "dgamma_dbeta_vs_float64": max(_bf16_max_mean(a, w)[0] for a, w in
                                               zip(outs["t"][1:], cs["want64"])),
                "same_bits_on_repeat": all(torch.equal(a, a2)
                                           for a, a2 in zip(first, outs["t"])),
                "host_us": _host_us(fn_), "bound_ms": cs["bound_ms"],
                **({"plan": plan(lib, cs["dims"])} if new_if[name] else {})}
            calls[name][case] = fn_
    _report(libs, ptxas, calls, errs, timer=lambda f: device_ms(f, 10, 5))
    for name, (_, so) in libs.items():
        print(json.dumps({"source": name, "sass": _build.sass_counts(so, "gn_silu_bwd")}),
              flush=True)
    return 0


# conv_in's bf16 wgrad (B, H, W, C, O): the flagship's (C 4 -> 64) and
# adm_edm_cond_h's (C 2 -> 64) at res 128, then ragged ones
WGRAD_NARROW_SHAPES = ((16, 128, 128, 4, 64), (16, 128, 128, 2, 64), (3, 13, 37, 8, 24),
                       (2, 29, 21, 3, 64))


def _time_wgradnarrowbf16(libs, ptxas) -> int:
    """conv_in's bf16 wgrad (`mc_conv_wgrad_bf16` at C <= 8, linear, with
    dbias) of every source, called directly at WGRAD_NARROW_SHAPES with the
    scratch rows of its own plan (`mc_conv_bwd_bf16_plan`): dW and dbias
    held to float64 (max of scale) and to their bits on a repeat; the call
    with its fixed-order reduce, on the card's clock and by the host's
    (`host_us`, the scratch and output allocated inside the call as the
    wrapper does); beside it bf16 `torch.ops.aten.convolution_backward` with
    output_mask [False, True, True] (the weight and bias gradients alone)
    on the same inputs; each case's plan and bound; each library's SASS."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    stream = torch.cuda.current_stream().cuda_stream
    bf = torch.bfloat16
    cases = {}
    for b, h, w, c, o in WGRAD_NARROW_SHAPES:
        x = torch.randn((b, h, w, c), generator=gen, device=dev).to(bf)
        g = torch.randn((b, h, w, o), generator=gen, device=dev).to(bf)
        x64 = x.double().permute(0, 3, 1, 2)
        g64 = g.double().permute(0, 3, 1, 2)
        dw64 = torch.nn.grad.conv2d_weight(x64, (o, c, 3, 3), g64, padding=1)
        want = (dw64.permute(2, 3, 1, 0).reshape(-1), g64.sum(dim=(0, 2, 3)))
        xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        wn = torch.zeros((o, c, 3, 3), device=dev, dtype=bf)

        def lib_call(xn=xn, gn=gn, wn=wn):
            return torch.ops.aten.convolution_backward(
                gn, xn, wn, [o], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                [False, True, True])
        k = 9 * c * o + o
        cases[f"B {b}, {h}x{w}, C {c} -> O {o}"] = dict(
            x=x, g=g, dims=(b, h, w, c, o), want=want, k=k, library=lib_call,
            bound_ms=(x.numel() + g.numel()) * 2 / 3.35e12 * 1e3)

    def plan(lib, dims):
        b, h, w, c, o = dims
        out = (ctypes.c_int * 5)()
        rc = lib.mc_conv_bwd_bf16_plan(1, 0, b, h, w, c, o, 9, out)
        if rc:
            raise RuntimeError(f"mc_conv_bwd_bf16_plan failed with cudaError {rc}")
        return dict(zip(("tile_rows", "resident", "blocks", "smem", "rows"), out))

    def call(name, lib, cs):
        b, h, w, c, o = cs["dims"]
        rows = plan(lib, cs["dims"])["rows"]
        outs = {}

        def run():
            dwb = torch.empty(cs["k"], device=dev)
            part = torch.empty((rows, cs["k"]), device=dev)
            outs["t"] = dwb
            rc = lib.mc_conv_wgrad_bf16(cs["x"].data_ptr(), cs["g"].data_ptr(), None, None,
                                        None, None, dwb.data_ptr(), part.data_ptr(), b, h, w,
                                        c, o, 1, 1e-5, 0, 9, 0, 1, rows, stream)
            if rc:
                raise RuntimeError(f"{name}: launch failed with cudaError {rc}")
        return run, outs

    lib_ms = {}
    for case, cs in cases.items():
        lib_ms[f"library ms {case}"] = device_ms(cs["library"], 10, 5)
    print(json.dumps({"library": "torch.ops.aten.convolution_backward, output_mask "
                      "[False, True, True], bf16", **lib_ms}), flush=True)
    calls, errs = {}, {}
    for name, (lib, _) in libs.items():
        calls[name], errs[name] = {}, {}
        for case, cs in cases.items():
            fn_, outs = call(name, lib, cs)
            fn_()
            torch.cuda.synchronize()
            first = outs["t"].clone()
            fn_()
            torch.cuda.synchronize()
            nw = cs["k"] - cs["dims"][4]
            got = outs["t"]
            errs[name][f"err {case}"] = {
                "dw": _bf16_max_mean(got[:nw], cs["want"][0])[0],
                "dbias": _bf16_max_mean(got[nw:], cs["want"][1])[0],
                "same_bits_on_repeat": bool(torch.equal(first, got)),
                "host_us": _host_us(fn_), "bound_ms": cs["bound_ms"],
                "plan": plan(lib, cs["dims"])}
            calls[name][case] = fn_
    _report(libs, ptxas, calls, errs, timer=lambda f: device_ms(f, 10, 5))
    for name, (_, so) in libs.items():
        print(json.dumps({"source": name, "sass": _build.sass_counts(so, "wgrad_narrow")}),
              flush=True)
    return 0


# K1's forward at the main path's shapes (B, N, C): the statistics pass at
# the 32x32 sites (B 16, and the CLI test's 80), then res 128 as context
# (on no bf16 path); the apply at its two sites
K1_STATS_SHAPES = ((16, 1024, 64), (16, 1024, 128), (80, 1024, 64), (80, 1024, 128),
                   (16, 16384, 64))
K1_APPLY_SHAPES = ((16, 16384, 64), (16, 4096, 64))


def _time_k1bf16(libs, ptxas) -> int:
    """K1's forward passes of every source, bf16 at the main path's shapes
    and fp32 beside: each output against the plain version, the statistics
    for the same bits on a repeat, then timed on the card's clock; each
    case's bytes bound and, for this package's interface, its launch plan."""
    from m_cedm_tpu_torch.kernels import fused_norm as fn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    bf = torch.bfloat16
    # this package's interface writes the sums whole; the parent's adds into
    # zeroed ones
    new_if = {name: hasattr(lib, "mc_channel_stats_plan") for name, (lib, _) in libs.items()}
    for name, (lib, _) in libs.items():
        if new_if[name]:
            lib.mc_channel_stats_plan.argtypes = [I, I, I, P]
            lib.mc_gn_silu_plan.argtypes = [I, I, I, I, P]

    def rnd(*shape, scale=1.0, shift=0.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)

    def bf16_err(got, want):
        err = (got.double() - want.double()).abs()
        scale = max(float(want.double().abs().max()), 1e-30)
        return float(err.max()) / scale, float(err.mean()) / scale

    cases, info = {}, {}
    for dt, shapes in ((bf, K1_STATS_SHAPES), (torch.float32, K1_STATS_SHAPES[:2]
                                                + K1_STATS_SHAPES[4:])):
        for b, n, c in shapes:
            x = rnd(b, n, c, scale=0.8, shift=0.2, dtype=dt)
            case = f"stats {'bf16' if dt == bf else 'fp32'} {(b, n, c)}"
            cases[case] = dict(kind="stats", x=x, b=b, n=n, c=c,
                               want=fn.channel_stats_plain(x))
            info[case] = {"bound_ms": (x.numel() * x.element_size() + 8 * b * c)
                          / 3.35e12 * 1e3}
    for dt, shapes in ((bf, K1_APPLY_SHAPES), (torch.float32, K1_APPLY_SHAPES[:1])):
        for b, n, c in shapes:
            x = rnd(b, n, c, scale=0.8, shift=0.2, dtype=dt)
            gamma, beta = rnd(b, c, scale=0.3, shift=1.0), rnd(b, c, scale=0.3)
            stats = fn.channel_stats_plain(x)
            groups = min(32, c // 4)
            case = f"apply {'bf16' if dt == bf else 'fp32'} {(b, n, c)}"
            cases[case] = dict(kind="apply", x=x, b=b, n=n, c=c, gamma=gamma, beta=beta,
                               stats=stats, groups=groups,
                               want=fn.gn_silu_plain(x, gamma, beta, groups, stats=stats))
            info[case] = {"bound_ms": (2 * x.numel() * x.element_size() + 16 * b * c)
                          / 3.35e12 * 1e3}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for case, cs in cases.items():
        vec = fn.fwd_vec(cs["c"], cs["x"].element_size(), True)
        if cs["kind"] == "stats":
            info[case]["mirror"] = fn.stats_plan(cs["n"], cs["c"], vec)
        else:
            info[case]["mirror"] = fn.apply_plan(cs["b"], cs["n"], cs["c"], vec, sms)
        for name, (lib, _) in libs.items():
            if new_if[name]:
                out = (ctypes.c_int * 4)()
                rc = (lib.mc_channel_stats_plan(cs["n"], cs["c"], vec, out)
                      if cs["kind"] == "stats" else
                      lib.mc_gn_silu_plan(cs["b"], cs["n"], cs["c"], vec, out))
                if rc:
                    raise RuntimeError(f"{name}: plan query failed with cudaError {rc}")
                info[case][name] = list(out)
    print(json.dumps({"k1bf16_cases": info}), flush=True)

    def call(name, lib, cs):
        x, b, n, c = cs["x"], cs["b"], cs["n"], cs["c"]
        sfx = "_bf16" if x.dtype == bf else ""

        def checked(rc):
            if rc:
                raise RuntimeError(f"{name}: launch failed with cudaError {rc}")
        if cs["kind"] == "stats":
            sums, sumsq = x.new_empty(b, c, dtype=torch.float32), x.new_empty(b, c, dtype=torch.float32)
            fn_ = getattr(lib, "mc_channel_stats" + sfx)

            def run():
                if not new_if[name]:
                    sums.zero_()
                    sumsq.zero_()
                checked(fn_(x.data_ptr(), sums.data_ptr(), sumsq.data_ptr(), b, n, c, stream))
            return run, (sums, sumsq)
        out = torch.empty_like(x)
        fn_ = getattr(lib, "mc_gn_silu" + sfx)
        ptrs = [t.data_ptr() for t in (x, cs["gamma"], cs["beta"], *cs["stats"], out)]

        def run():
            checked(fn_(*ptrs, b, n, c, cs["groups"], 1e-5, stream))
        return run, (out,)

    calls, errs = {}, {}
    for name, (lib, _) in libs.items():
        calls[name], errs[name] = {}, {}
        for case, cs in cases.items():
            run, outs = call(name, lib, cs)
            run()
            torch.cuda.synchronize()
            first = [t.clone() for t in outs]
            run()
            torch.cuda.synchronize()
            if cs["kind"] == "stats":
                errs[name][f"err {case}"] = max(bf16_err(a, w)[0]
                                                for a, w in zip(outs, cs["want"]))
                errs[name][f"same bits {case}"] = all(torch.equal(a, a2)
                                                      for a, a2 in zip(first, outs))
            elif outs[0].dtype == bf:
                errs[name][f"err {case}"] = bf16_err(outs[0], cs["want"])
            else:
                errs[name][f"err {case}"] = _rel(outs[0], cs["want"].double())
            calls[name][case] = run
        for case, cs in cases.items():  # the card's copy of the apply's bytes
            if cs["kind"] == "apply":
                out = torch.empty_like(cs["x"])
                calls[name][f"copy {case[6:]} (library, x into y)"] = (
                    lambda out=out, x=cs["x"]: out.copy_(x))
    _report(libs, ptxas, calls, errs, timer=lambda fn_: device_ms(fn_, repeats=5))
    return 0


# the narrow route's calls (B, H, W, C, O, statistics): the flagship's conv_in
# and out conv, adm_edm_cond_h's, and the flagship's at the CLI test's batch 80
NARROW_CASES = (("conv_in C 4 -> 64, stats", 16, 4, 64, True),
                ("conv_in C 4 -> 64, no stats", 16, 4, 64, False),
                ("out conv C 64 -> 2", 16, 64, 2, False),
                ("cond_h conv_in C 2 -> 64, stats", 16, 2, 64, True),
                ("cond_h out conv C 64 -> 1", 16, 64, 1, False),
                ("conv_in C 4 -> 64, stats, B 80", 80, 4, 64, True),
                ("out conv C 64 -> 2, B 80", 80, 64, 2, False))
NARROW_RES = 128


def _time_narrowbf16(libs, ptxas) -> int:
    """The bf16 narrow convs of every source called directly
    (`mc_narrow_conv_bf16`) at NARROW_CASES, and the out conv's backward
    (`mc_narrow_conv_bwd_bf16`, C 64 -> O 2) with and without its input
    gradient (the dgrad instance is the difference); each output held to the
    bf16 plain version (max and mean error of scale, the statistics apart)
    and to its own bits on a repeat, then timed on the card's clock. Beside
    them the fp32 instances (`mc_narrow_conv`) and bf16 conv2d at the
    flagship's two shapes; each case's bytes bound at 3.35 TB/s; for a source
    that exports `mc_narrow_conv_plan` each case's launch plan."""
    import torch.nn.functional as tnf

    from m_cedm_tpu_torch.kernels import fused_norm_conv as fnc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    bf = torch.bfloat16
    res = NARROW_RES
    for name, (lib, _) in libs.items():
        if hasattr(lib, "mc_narrow_conv_plan"):
            lib.mc_narrow_conv_plan.argtypes = [I] * 5 + [P]

    def rnd(*shape, scale=1.0, shift=0.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)

    def bf16_err(got, want):
        err = (got.double() - want.double()).abs()
        scale = max(float(want.double().abs().max()), 1e-30)
        return float(err.max()) / scale, float(err.mean()) / scale

    cases, info = {}, {}
    for case, b, c, o, stats in NARROW_CASES:
        x = rnd(b, res, res, c, scale=0.8, shift=0.2)
        w = rnd(3, 3, c, o, scale=(9 * c) ** -0.5)
        bias = rnd(o, scale=0.3, dtype=torch.float32)
        with torch.no_grad():
            want = fnc.narrow_conv_plain(x, w, bias, stats)
        cases[case] = dict(x=x, w=w, bias=bias, b=b, c=c, o=o, stats=stats,
                           want=want if stats else (want, None))
        info[case] = {"bound_ms": (x.numel() * 2 + w.numel() * 2 + 4 * o + b * res * res * o * 2
                                   + (8 * b * o if stats else 0)) / 3.35e12 * 1e3}
    # the out conv's backward at the flagship's shape
    xb, wb = cases["out conv C 64 -> 2"]["x"], cases["out conv C 64 -> 2"]["w"]
    gy = rnd(16, res, res, 2)
    with torch.no_grad():
        want_bwd = fnc.narrow_conv_bwd_plain(gy, xb, wb)
    info["bwd C 64 -> 2"] = {"bound_ms": (2 * xb.numel() * 2 + gy.numel() * 2 + wb.numel() * 2
                                          + 4 * (wb.numel() + 2)) / 3.35e12 * 1e3,
                             "dgrad_bound_ms": (xb.numel() * 2 + gy.numel() * 2
                                                + wb.numel() * 2) / 3.35e12 * 1e3}
    for case, cs in cases.items():
        for name, (lib, _) in libs.items():
            if hasattr(lib, "mc_narrow_conv_plan"):
                out = (ctypes.c_int * 6)()
                rc = lib.mc_narrow_conv_plan(cs["b"], res, res, cs["c"], cs["o"], out)
                info[case][name] = list(out) if rc == 0 else {"error": rc}
    print(json.dumps({"narrowbf16_cases": info}), flush=True)

    def checked(name, rc):
        if rc:
            raise RuntimeError(f"{name}: launch failed with cudaError {rc}")

    def call(name, lib, cs, fp32=False):
        x, w, bias, b, c, o = (cs[k] for k in ("x", "w", "bias", "b", "c", "o"))
        if fp32:
            x, w = x.float(), w.float()
        out = torch.empty(b, res, res, o, device=dev, dtype=x.dtype)
        ostats = part = None
        if cs["stats"]:
            # the bf16 narrow-C tiles: 3 in a source with mc_narrow_conv_plan,
            # 1 (the fp32 kernel's, which served both) before it
            which = 0 if o <= 8 else 3 if hasattr(lib, "mc_narrow_conv_plan") and not fp32 else 1
            tiles = lib.mc_narrow_conv_tiles(res, res, which)
            ostats = torch.empty(2, b, o, device=dev)
            part = torch.empty(2, b, tiles, o, device=dev)
        fn_ = lib.mc_narrow_conv if fp32 else lib.mc_narrow_conv_bf16
        ptrs = [None if t is None else t.data_ptr() for t in (x, w, bias, out, ostats, part)]

        def run():
            checked(name, fn_(*ptrs, b, res, res, c, o, stream))
        return run, (out, ostats)

    def call_bwd(name, lib, need_dx):
        dx = torch.empty_like(xb) if need_dx else None
        tiles = lib.mc_narrow_conv_tiles(res, res, 2)
        runs = min(tiles, -(-fnc._NARROW_WGRAD_BLOCKS // 16))
        dwb = torch.empty(9 * 64 * 2 + 2, device=dev)
        part = torch.empty(16 * runs, 9 * 64 * 2 + 2, device=dev)
        ptrs = [None if t is None else t.data_ptr() for t in (gy, xb, wb, dx, dwb, part)]

        def run():
            checked(name, lib.mc_narrow_conv_bwd_bf16(*ptrs, 16, res, res, 64, 2, runs, stream))
        return run, (dx, dwb)

    calls, errs = {}, {}
    for name, (lib, _) in libs.items():
        calls[name], errs[name] = {}, {}
        for case, cs in cases.items():
            run, (out, ostats) = call(name, lib, cs)
            run()
            torch.cuda.synchronize()
            first = [out.clone(), None if ostats is None else ostats.clone()]
            run()
            torch.cuda.synchronize()
            want, wstats = cs["want"]
            rec = {"out": bf16_err(out, want),
                   "same bits": torch.equal(first[0], out)
                   and (ostats is None or torch.equal(first[1], ostats))}
            if ostats is not None:
                rec["stats"] = max(bf16_err(ostats[i], wstats[i])[0] for i in range(2))
            errs[name][f"err {case}"] = rec
            calls[name][case] = run
        for need_dx in (True, False):
            run, (dx, dwb) = call_bwd(name, lib, need_dx)
            run()
            torch.cuda.synchronize()
            first = [t.clone() for t in (dx, dwb) if t is not None]
            run()
            torch.cuda.synchronize()
            key = "bwd C 64 -> 2" + ("" if need_dx else ", no dx")
            rec = {"dw": bf16_err(dwb[:-2], want_bwd[1].reshape(-1))[0],
                   "dbias": bf16_err(dwb[-2:], want_bwd[2])[0],
                   "same bits": all(torch.equal(a, t) for a, t in
                                    zip(first, [t for t in (dx, dwb) if t is not None]))}
            if dx is not None:
                rec["dx"] = bf16_err(dx, want_bwd[0])
            errs[name][f"err {key}"] = rec
            calls[name][key] = run
        for case in ("conv_in C 4 -> 64, stats", "out conv C 64 -> 2"):
            cs = cases[case]
            calls[name][f"fp32 instance {case}"] = call(name, lib, cs, fp32=True)[0]
            calls[name][f"bf16 conv2d {case} (library)"] = (
                lambda cs=cs: tnf.conv2d(cs["x"].permute(0, 3, 1, 2),
                                         cs["w"].permute(3, 2, 0, 1), cs["bias"].to(bf),
                                         padding=1))
    _report(libs, ptxas, calls, errs, timer=lambda fn_: device_ms(fn_, repeats=5))
    return 0


def _leaves(out):
    """out or (out, (sums, sumsq)) as a flat list."""
    return [out[0], *out[1]] if isinstance(out, tuple) else [out]


if __name__ == "__main__":
    sys.exit(main())
