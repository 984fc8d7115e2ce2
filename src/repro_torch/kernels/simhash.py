"""``simhash_pack``: dense SimHash sketches, sign(W̄·R) packed to bits.

Hopper port of the Pallas TPU kernel
``src/repro/kernels/simhash.py:simhash_pack``. The CUDA kernel is
``csrc/simhash_pack.cu``: the tiled FP32 SGEMM of ``masked_gram`` (64×64
tiles, IEEE FMA, no TF32) with the sign and the bit packing fused into the
epilogue (one ``__ballot_sync`` per 32 sample columns of a row). Its header
says what bounds it (FP32 operations).

Operand contract, shared by the kernel and :func:`simhash_pack_plain`:
``w`` float32[n, n], ``r`` float32[n, k] with k % 32 == 0. Returns
uint32[n, k/32]: bit ``s`` of word ``j`` is ``(w @ r)[v, 32j+s] >= 0``.

Summation order: the kernel and the plain version (``torch.matmul``) sum
in different orders, so a bit whose exact sum lies within the forward
error bound (n·2⁻²⁴·Σ|w||r|) may differ between them. On exact inputs
(0/1 ``w``, ``r`` on a coarse dyadic grid) every partial sum is exact and
the words are bit-identical.

:func:`simhash_pack` launches the kernel for CUDA tensors and uses the
plain version only for CPU tensors; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.backend.padding import pad_to
from repro_torch.kernels import _build
from repro_torch.kernels.triangle_count import ieee_fp32_matmul

TILE = 64          # the kernel's output tile; the wrapper pads n and k to it

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


def _check(w: torch.Tensor, r: torch.Tensor) -> None:
    if w.dim() != 2 or w.shape[0] != w.shape[1] or r.dim() != 2 \
            or r.shape[0] != w.shape[0]:
        raise ValueError(
            f"simhash_pack needs w [n, n] and r [n, k], got "
            f"{tuple(w.shape)} and {tuple(r.shape)}")
    if r.shape[1] % 32:
        raise ValueError(f"k={r.shape[1]} must be a multiple of 32")
    if w.dtype != torch.float32 or r.dtype != torch.float32:
        raise TypeError("simhash_pack operands must be float32")
    if w.device != r.device:
        raise ValueError("simhash_pack operands must share one device")


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool[n, k] (k % 32 == 0) → uint32[n, k/32], bit s of word j =
    column 32j+s; the arithmetic runs in int64 (CPU uint32 has no
    ``+``)."""
    n, k = bits.shape
    lanes = bits.reshape(n, k // 32, 32).to(torch.int64)
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=bits.device),
        torch.arange(32, dtype=torch.int64, device=bits.device))
    words = (lanes * weights).sum(dim=-1)
    # two's-complement wrap into int32, then reinterpret the bits
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32).view(torch.uint32)


def simhash_pack_plain(w: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``w @ r`` with TF32 off, sign, pack."""
    _check(w, r)
    with ieee_fp32_matmul():
        s = w @ r
    return pack_bits(s >= 0.0)


def simhash_pack(w: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Packed sketches uint32[n, k/32]; the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    _check(w, r)
    dev = w.device
    if dev.type == "cpu":
        return simhash_pack_plain(w, r)
    if dev.type != "cuda":
        raise ValueError(f"simhash_pack: unsupported device {dev}")
    n0, k0 = r.shape
    out_words = k0 // 32
    if n0 == 0 or k0 == 0:
        return torch.empty((n0, out_words), dtype=torch.uint32, device=dev)
    wp = pad_to(w, TILE, (0, 1)).contiguous()
    rp = pad_to(r, TILE, (0, 1)).contiguous()
    n, k = rp.shape
    out = torch.empty((n, k // 32), dtype=torch.int32, device=dev)
    fn = _build.function("simhash_pack", "simhash_pack_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(wp.data_ptr(), rp.data_ptr(), out.data_ptr(), n, k,
                 _build.stream_handle(dev))
    _build.check_launch("simhash_pack", err)
    return out[:n0, :out_words].contiguous().view(torch.uint32)
