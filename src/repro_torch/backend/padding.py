"""Shared padding / power-of-two shape helpers (port of
``repro.backend.padding``)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def pow2ceil(x: int, floor: int = 1) -> int:
    """Smallest power of two ≥ max(x, floor)."""
    v = max(int(x), floor, 1)
    return 1 << (v - 1).bit_length()


def pow2_bucket(total: int, floor: int = 64) -> int:
    """Smallest power-of-two ≥ ``total`` (≥ ``floor``): the fixed chunk
    shapes of the similarity engine."""
    b = floor
    while b < total:
        b <<= 1
    return b


def np_pow2ceil(x: np.ndarray) -> np.ndarray:
    """Elementwise :func:`pow2ceil` (floor 1), int64."""
    x = np.maximum(np.asarray(x, np.int64), 1)
    return 1 << np.ceil(np.log2(x)).astype(np.int64)


def np_log2(x: np.ndarray) -> np.ndarray:
    """Elementwise exact log2 of power-of-two int arrays, int64."""
    return np.log2(np.asarray(x, np.int64)).astype(np.int64)


def pad1(a: np.ndarray, pad: int, fill) -> np.ndarray:
    """Append ``pad`` copies of ``fill`` to a 1-d numpy array."""
    if pad == 0:
        return a
    return np.concatenate([a, np.full(pad, fill, dtype=a.dtype)])


def pad_to(x: torch.Tensor, mult: int, axes) -> torch.Tensor:
    """Zero-pad ``axes`` of ``x`` up to the next multiple of ``mult``."""
    pads = [0] * (2 * x.dim())
    for ax in axes:
        ax = ax % x.dim()
        # F.pad lists (left, right) pairs from the last axis backwards
        pads[2 * (x.dim() - 1 - ax) + 1] = (-x.shape[ax]) % mult
    if not any(pads):
        return x
    return F.pad(x, pads)
