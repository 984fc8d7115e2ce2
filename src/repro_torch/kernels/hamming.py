"""``hamming_cosine``: per-edge SimHash sketch comparison, cos(π·d/k).

Hopper port of the Pallas TPU kernel
``src/repro/kernels/hamming.py:hamming_cosine``. The CUDA kernel is
``csrc/hamming_cosine.cu``; its header says what bounds it (memory: the
ids and σ̂ of every edge plus the sketch table once, with a random sketch
row read per edge on top) and what the design does about it (one thread
per edge gathers both rows itself, so the two ``[e, words]`` copies the TPU
kernel took as operands are never written).

Operand contract, shared by the kernel and :func:`hamming_cosine_plain`:
``sketches`` uint32[n, words] (packed bits, bit ``s`` of word ``w`` =
sample ``32w+s``), ``eu``/``ev`` int32[e] row ids < n. Returns σ̂
float32[e] = cos((f32(π)·diff)/samples), with
diff = Σ_w popcount(u_w XOR v_w). The plain version also returns diff
int32[e] with ``return_diff``; the kernel writes σ̂ alone, which is
one-to-one with diff (distinct diffs give distinct float32 cosines).

:func:`hamming_cosine` launches the kernel for CUDA tensors and uses the
plain version only for CPU tensors; it never falls back.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

# plain-version working set per step, in edges (the gathered rows and their
# int64 widening stay a few hundred MB at 8 words)
_PLAIN_CHUNK_EDGES = 1 << 22

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]


def _check(sketches, eu, ev, samples) -> None:
    if sketches.dim() != 2 or sketches.dtype != torch.uint32:
        raise TypeError("sketches must be uint32[n, words]")
    if eu.dim() != 1 or eu.shape != ev.shape:
        raise ValueError(
            f"eu/ev must be matching 1-d, got {tuple(eu.shape)} and "
            f"{tuple(ev.shape)}")
    if eu.dtype != torch.int32 or ev.dtype != torch.int32:
        raise TypeError("edge endpoints must be int32")
    if len({t.device for t in (sketches, eu, ev)}) != 1:
        raise ValueError("hamming_cosine operands must share one device")
    if samples <= 0:
        raise ValueError(f"samples must be positive, got {samples}")


def popcount_i64(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of 32-bit values held in int64 (CPU uint32 has no
    ``>>``, ``+`` or ``-``), as the reference's ``_popcount_u32``."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def theta_of_diff(diff: torch.Tensor, samples: int) -> torch.Tensor:
    """θ̂ = (f32(π)·diff)/samples in float32: the reference's
    ``jnp.pi * diff / samples`` order, one rounding per operation. Both
    constants are tensors on ``diff``'s device: PyTorch on CUDA divides by
    a Python scalar as a product with its reciprocal, which is not the
    IEEE quotient the kernel computes."""
    pi32, k = torch.tensor([math.pi, float(samples)], dtype=torch.float32,
                           device=diff.device)
    return (diff.to(torch.float32) * pi32) / k


def cosine_of_diff(diff: torch.Tensor, samples: int) -> torch.Tensor:
    """σ̂ = cos(θ̂) in float32."""
    return torch.cos(theta_of_diff(diff, samples))


def hamming_cosine_plain(sketches: torch.Tensor, eu: torch.Tensor,
                         ev: torch.Tensor, samples: int, *,
                         return_diff: bool = False):
    """Plain PyTorch version: gather, XOR, SWAR popcount in int64, the
    cosine epilogue; in edge slabs."""
    _check(sketches, eu, ev, samples)
    sk = sketches.view(torch.int32)
    e = eu.shape[0]
    diff = torch.empty(e, dtype=torch.int32, device=sk.device)
    for s in range(0, e, _PLAIN_CHUNK_EDGES):
        x = sk[eu[s: s + _PLAIN_CHUNK_EDGES].long()] \
            ^ sk[ev[s: s + _PLAIN_CHUNK_EDGES].long()]
        bits = popcount_i64(x.long() & 0xFFFFFFFF)
        diff[s: s + _PLAIN_CHUNK_EDGES] = bits.sum(dim=1).to(torch.int32)
    sim = cosine_of_diff(diff, samples)
    return (sim, diff) if return_diff else sim


def hamming_cosine(sketches: torch.Tensor, eu: torch.Tensor,
                   ev: torch.Tensor, samples: int) -> torch.Tensor:
    """σ̂ float32[e]; the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    _check(sketches, eu, ev, samples)
    dev = sketches.device
    if dev.type == "cpu":
        return hamming_cosine_plain(sketches, eu, ev, samples)
    if dev.type != "cuda":
        raise ValueError(f"hamming_cosine: unsupported device {dev}")
    if not all(t.is_contiguous() for t in (sketches, eu, ev)):
        raise ValueError("hamming_cosine operands must be contiguous")
    e, words = eu.shape[0], sketches.shape[1]
    sim = torch.empty(e, dtype=torch.float32, device=dev)
    if e:
        fn = _build.function("hamming_cosine", "hamming_cosine_launch",
                             _ARGTYPES)
        with torch.cuda.device(dev):
            err = fn(sketches.data_ptr(), eu.data_ptr(), ev.data_ptr(),
                     sim.data_ptr(), e, words, int(samples),
                     _build.stream_handle(dev))
        _build.check_launch("hamming_cosine", err)
    return sim
