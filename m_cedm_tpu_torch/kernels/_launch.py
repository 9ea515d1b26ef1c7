"""Shared checks for the kernel wrappers: what a CUDA kernel accepts, how it
is launched on PyTorch's stream, and how its result code is read.

Every differentiable wrapper is a torch.autograd.Function. For CUDA tensors
its forward and its backward both launch hand-written kernels; for CPU
tensors the forward is the plain PyTorch version and the backward is the
plain version of the backward kernel (the explicit formulas the kernel
implements, not autograd of the plain forward), so the CPU tests exercise the
math of each backward kernel."""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def on_cpu(t: torch.Tensor) -> bool:
    """The wrappers run their plain version only for tensors on the CPU; a
    CUDA tensor always goes to the kernel (or the wrapper raises)."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def check(t: torch.Tensor, name: str, shape: Sequence[int], device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def raise_on_error(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed with cudaError {rc}")


def fp32_reference_math() -> None:
    """Plain versions that run on the card compare against full-fp32
    kernels: cuDNN convolutions use TF32 by default, so turn that (and TF32
    matmuls) off before computing a reference."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
