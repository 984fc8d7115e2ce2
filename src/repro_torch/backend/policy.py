"""The :class:`ExecutionPolicy`: one dispatch decision for every hot op
(port of ``repro.backend.policy``).

Two lanes:

* ``ref`` — the plain PyTorch version of the op (CPU or CUDA);
* ``hopper`` — the hand-written CUDA kernel (CUDA tensors only).

The lane follows the operand's device, resolved on every call: a CPU
tensor runs ``ref``, a CUDA tensor runs ``hopper`` for every group of an
op that has a kernel — there is no width cutoff that sends small groups
to the plain version on the card. ``ref`` on CUDA is reachable only
through an explicit ``lane=`` argument (the on-card comparison phases use
it); no environment variable moves a call off the kernel. A forced lane
clamps to the lanes the op has registered, and forcing ``hopper`` onto
CPU tensors raises rather than quietly running the plain version.

``note()`` counts each dispatch decision into the policy's ``counts``
dict under ``"<op>.<lane>"``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.backend.profile import DEFAULT_PROFILE

LANE_REF = "ref"
LANE_HOPPER = "hopper"
LANES = (LANE_REF, LANE_HOPPER)

# the kernel registry: hot op → lanes that can answer it
OPS = {
    "bucket_probe": LANES,
    "triangle_count": LANES,
    "simhash": LANES,
    "hamming": LANES,
    "query": (LANE_REF,),       # (μ, ε) query path is plain torch ops
}


def _check_lane(lane: str) -> str:
    if lane not in LANES:
        raise ValueError(f"unknown lane {lane!r}; expected one of {LANES}")
    return lane


class ExecutionPolicy:
    """Per-call lane resolution + profile + dispatch counters."""

    def __init__(self) -> None:
        self.profile = DEFAULT_PROFILE
        self.counts: Dict[str, int] = {}

    def lane(self, op: str, device: torch.device,
             forced: Optional[str] = None) -> str:
        """Which lane answers ``op`` for operands on ``device``."""
        avail = OPS.get(op, (LANE_REF,))
        device = torch.device(device)
        if forced is not None:
            lane = _check_lane(forced)
            if lane not in avail:
                return LANE_REF
            if lane == LANE_HOPPER and device.type != "cuda":
                raise ValueError(
                    f"lane {LANE_HOPPER!r} runs CUDA kernels; operands of "
                    f"{op!r} are on {device}")
            return lane
        if device.type == "cuda" and LANE_HOPPER in avail:
            return LANE_HOPPER
        return LANE_REF

    def note(self, op: str, lane: str, count: int = 1) -> None:
        """Record ``count`` dispatch decisions."""
        if count:
            key = f"{op}.{lane}"
            self.counts[key] = self.counts.get(key, 0) + count


_DEFAULT: Optional[ExecutionPolicy] = None


def default_policy() -> ExecutionPolicy:
    """The process-wide policy every dispatch goes through."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = ExecutionPolicy()
    return _DEFAULT
