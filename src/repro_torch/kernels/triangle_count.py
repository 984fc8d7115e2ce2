"""``masked_gram``: the blocked masked adjacency product (W̄·W̄ᵀ) ⊙ M.

Hopper port of the Pallas TPU kernel
``src/repro/kernels/triangle_count.py:masked_gram``. The CUDA kernel is
``csrc/masked_gram.cu``: a shared-memory tiled FP32 SGEMM (64×64 tiles,
no TF32, no tensor cores) with the mask applied before the store. Its
header says what bounds it (FP32 operations) and why the design keeps IEEE
FP32 (unweighted products are then bit-identical to the plain version).

:func:`masked_gram` launches the kernel for CUDA tensors and uses
:func:`masked_gram_plain` only for CPU tensors; it never falls back.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from repro_torch.backend.padding import pad_to
from repro_torch.kernels import _build

TILE = 64          # the kernel's output tile; the wrapper pads n to it

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]


@contextlib.contextmanager
def ieee_fp32_matmul():
    """Run float32 matrix products in full IEEE float32 on CUDA: TF32 off
    (TF32 rounds inputs to a 10-bit mantissa, which weighted adjacency
    does not survive). Restores the previous settings on exit."""
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    prev_prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
        torch.set_float32_matmul_precision(prev_prec)


def _check(w: torch.Tensor, mask: torch.Tensor) -> None:
    if w.dim() != 2 or w.shape[0] != w.shape[1] or mask.shape != w.shape:
        raise ValueError(
            f"masked_gram needs square [n, n] operands, got "
            f"{tuple(w.shape)} and {tuple(mask.shape)}")
    if w.dtype != torch.float32 or mask.dtype != torch.float32:
        raise TypeError("masked_gram operands must be float32")
    if w.device != mask.device:
        raise ValueError("masked_gram operands must share one device")


def masked_gram_plain(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``(w @ w.T) * mask``, TF32 off."""
    _check(w, mask)
    with ieee_fp32_matmul():
        return (w @ w.T) * mask


def masked_gram(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(W̄·W̄ᵀ) ⊙ mask, float32[n, n]; the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    _check(w, mask)
    dev = w.device
    if dev.type == "cpu":
        return masked_gram_plain(w, mask)
    if dev.type != "cuda":
        raise ValueError(f"masked_gram: unsupported device {dev}")
    n0 = w.shape[0]
    if n0 == 0:
        return torch.empty((0, 0), dtype=torch.float32, device=dev)
    wp = pad_to(w, TILE, (0, 1)).contiguous()
    mp = pad_to(mask, TILE, (0, 1)).contiguous()
    n = wp.shape[0]
    out = torch.empty((n, n), dtype=torch.float32, device=dev)
    fn = _build.function("masked_gram", "masked_gram_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(wp.data_ptr(), mp.data_ptr(), out.data_ptr(), n,
                 _build.stream_handle(dev))
    _build.check_launch("masked_gram", err)
    return out[:n0, :n0]
