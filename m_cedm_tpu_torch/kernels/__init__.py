"""Hand-written Hopper kernels of the port and the op sets the models run.

The U-Net calls its fused operations (the whole-block K7 on its sampling
path with `mega=True`), and the OFormer its two linear-attention products,
through an `Ops` set:

  DEVICE_OPS  the kernel wrappers, each a torch.autograd.Function: the CUDA
              kernels (forward and backward) for CUDA tensors, the plain
              PyTorch versions for CPU tensors (the default);
  PLAIN_OPS   the plain PyTorch forwards on any device, differentiated by
              ordinary autograd: the reference the kernels are held against
              on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from m_cedm_tpu_torch.kernels.fused_attention import (attention,
                                                      attention_bwd,
                                                      attention_plain)
from m_cedm_tpu_torch.kernels.fused_block import (fused_unet_block,
                                                  fused_unet_block_plain)
from m_cedm_tpu_torch.kernels.fused_norm import (channel_stats,
                                                 channel_stats_plain, gn_silu,
                                                 gn_silu_bwd, gn_silu_plain)
from m_cedm_tpu_torch.kernels.fused_norm_conv import (gn_dx, gn_silu_conv,
                                                      gn_silu_conv_bwd,
                                                      gn_silu_conv_plain,
                                                      gn_silu_up_conv,
                                                      gn_silu_up_conv_bwd,
                                                      gn_silu_up_conv_plain,
                                                      narrow_conv,
                                                      narrow_conv_bwd)
from m_cedm_tpu_torch.kernels.linear_attention import (apply_dots,
                                                       apply_dots_plain,
                                                       kv_dots, kv_dots_plain)


@dataclasses.dataclass(frozen=True)
class Ops:
    gn_silu: Callable
    gn_silu_conv: Callable
    gn_silu_up_conv: Callable
    attention: Callable
    kv_dots: Callable
    apply_dots: Callable
    unet_block: Callable
    channel_stats: Callable


DEVICE_OPS = Ops(gn_silu, gn_silu_conv, gn_silu_up_conv, attention, kv_dots,
                 apply_dots, fused_unet_block, channel_stats)
PLAIN_OPS = Ops(gn_silu_plain, gn_silu_conv_plain, gn_silu_up_conv_plain,
                attention_plain, kv_dots_plain, apply_dots_plain,
                fused_unet_block_plain, channel_stats_plain)

# every kernel wrapper, by the name chip_smoke.py reports
WRAPPERS: Dict[str, Callable] = {
    "K1 gn_silu": gn_silu,
    "K1 channel_stats": channel_stats,
    "K2 gn_silu_conv": gn_silu_conv,
    "K2 narrow_conv": narrow_conv,
    "K3 gn_silu_up_conv": gn_silu_up_conv,
    "K4 attention": attention,
    "K1 gn_silu_bwd": gn_silu_bwd,
    "K2 gn_silu_conv_bwd": gn_silu_conv_bwd,
    "K2 narrow_conv_bwd": narrow_conv_bwd,
    "K3 gn_silu_up_conv_bwd": gn_silu_up_conv_bwd,
    "K2 gn_dx": gn_dx,  # the bf16 K2 / K3 backward's dx pass
    "K4 attention_bwd": attention_bwd,
    "K5 kv_dots": kv_dots,
    "K6 apply_dots": apply_dots,
    "K7 unet_block": fused_unet_block,
}
# K5's and K6's bf16 instances: the same wrappers, counted apart from fp32
BF16_COUNTED: Dict[str, Callable] = {"K5 kv_dots bf16": kv_dots,
                                     "K6 apply_dots bf16": apply_dots}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    for fn in BF16_COUNTED.values():
        fn.launches_bf16 = 0


def launches() -> Dict[str, int]:
    """Launches since the last reset, by the name chip_smoke.py reports."""
    return {**{name: fn.launches for name, fn in WRAPPERS.items()},
            **{name: fn.launches_bf16 for name, fn in BF16_COUNTED.items()}}
