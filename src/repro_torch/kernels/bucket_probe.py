"""``bucket_probe``: shared-neighbor dot and count per edge.

Hopper port of the Pallas TPU kernel
``src/repro/kernels/bucket_probe.py:bucket_probe``. The CUDA kernel is
``csrc/bucket_probe.cu``; its header says what bounds it on the H100
(memory: a few compares per byte) and what the design does about it (one
warp per edge, binary search of each probe id in the target row instead of
the TPU's all-pairs compare, which a 131072-wide hub row makes quadratic).

Operand contract, shared by the kernel and :func:`bucket_probe_plain`:
rows as the similarity engine gathers them — sorted ascending, distinct
real ids < ``n``, pads (id ``n``) after the real ids. Unlike the TPU
kernel, pads need no sanitising to -1/-2 and ``e``/``T`` need no block
multiple.

:func:`bucket_probe` launches the kernel for CUDA tensors and uses the
plain version only for CPU tensors; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# plain-version working set per step, in row elements (hub groups are
# evaluated a slab of edges at a time)
_PLAIN_CHUNK_ELEMS = 1 << 24

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


def _check(rows_p, w_p, rows_t, w_t, n) -> None:
    ts = (rows_p, w_p, rows_t, w_t)
    if any(t.dim() != 2 for t in ts):
        raise ValueError("bucket_probe operands must be 2-d [e, width]")
    if rows_p.dtype != torch.int32 or rows_t.dtype != torch.int32:
        raise TypeError("row ids must be int32")
    if w_p.dtype != torch.float32 or w_t.dtype != torch.float32:
        raise TypeError("row weights must be float32")
    if w_p.shape != rows_p.shape or w_t.shape != rows_t.shape \
            or rows_p.shape[0] != rows_t.shape[0]:
        raise ValueError(
            f"shape mismatch: {tuple(rows_p.shape)}/{tuple(w_p.shape)} vs "
            f"{tuple(rows_t.shape)}/{tuple(w_t.shape)}")
    if len({t.device for t in ts}) != 1:
        raise ValueError("bucket_probe operands must share one device")
    if not 0 <= n < 2 ** 31:
        raise ValueError(f"n={n} out of int32 range")


def bucket_probe_plain(rows_p: torch.Tensor, w_p: torch.Tensor,
                       rows_t: torch.Tensor, w_t: torch.Tensor,
                       n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the ``torch.searchsorted`` form of the
    reference engine's ``_bucket_sims_core`` body, in edge slabs so hub
    groups fit. Returns (dot float32[e], cnt int32[e])."""
    _check(rows_p, w_p, rows_t, w_t, n)
    e, p = rows_p.shape
    t = rows_t.shape[1]
    dot = torch.zeros(e, dtype=torch.float32, device=rows_p.device)
    cnt = torch.zeros(e, dtype=torch.int32, device=rows_p.device)
    if e == 0 or p == 0 or t == 0:
        return dot, cnt
    step = max(_PLAIN_CHUNK_ELEMS // (p + t), 1)
    for s in range(0, e, step):
        rp = rows_p[s: s + step]
        rt = rows_t[s: s + step].contiguous()
        pos = torch.searchsorted(rt, rp.contiguous()).clamp_max_(t - 1)
        hit = (torch.gather(rt, 1, pos) == rp) & (rp < n)
        w_match = torch.gather(w_t[s: s + step], 1, pos)
        dot[s: s + step] = torch.where(hit, w_p[s: s + step] * w_match,
                                       0.0).sum(dim=1)
        cnt[s: s + step] = hit.sum(dim=1, dtype=torch.int32)
    return dot, cnt


def bucket_probe(rows_p: torch.Tensor, w_p: torch.Tensor,
                 rows_t: torch.Tensor, w_t: torch.Tensor,
                 n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(dot float32[e], cnt int32[e]) per edge; the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check(rows_p, w_p, rows_t, w_t, n)
    dev = rows_p.device
    if dev.type == "cpu":
        return bucket_probe_plain(rows_p, w_p, rows_t, w_t, n)
    if dev.type != "cuda":
        raise ValueError(f"bucket_probe: unsupported device {dev}")
    if not all(x.is_contiguous() for x in (rows_p, w_p, rows_t, w_t)):
        raise ValueError("bucket_probe operands must be contiguous")
    e, p = rows_p.shape
    t = rows_t.shape[1]
    dot = torch.empty(e, dtype=torch.float32, device=dev)
    cnt = torch.empty(e, dtype=torch.int32, device=dev)
    if e == 0:
        return dot, cnt
    fn = _build.function("bucket_probe", "bucket_probe_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(rows_p.data_ptr(), w_p.data_ptr(), rows_t.data_ptr(),
                 w_t.data_ptr(), dot.data_ptr(), cnt.data_ptr(), e, p, t,
                 int(n), _build.stream_handle(dev))
    _build.check_launch("bucket_probe", err)
    return dot, cnt
