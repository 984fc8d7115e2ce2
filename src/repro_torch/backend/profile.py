"""Dispatch thresholds: the :class:`AutotuneProfile` (port of
``repro.backend.profile``).

Same fields and defaults as the reference, so a profile persisted by
either package reads in the other. The fields that name Pallas block
shapes are carried for that reason; the port's CUDA kernels pick their
own launch shapes. The one-shot ``autotune()`` sweep is not ported yet.
"""
from __future__ import annotations

import dataclasses
import json

PROFILE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class AutotuneProfile:
    """Dispatch thresholds for one platform. Defaults = legacy constants."""

    version: int = PROFILE_VERSION
    platform: str = "default"     # backend the sweep ran on ("default" = untuned)
    hub_tile: int = 2048          # storage tile width for hub rows
    probe_min_width: int = 256    # reference's TPU probe cutoff (unused here)
    gram_block: int = 128
    probe_be: int = 256
    probe_bt: int = 256
    simhash_block: int = 128
    hamming_block: int = 1024
    probe_interpret_chunk: int = 512

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, payload: str) -> "AutotuneProfile":
        data = json.loads(payload)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in names})


DEFAULT_PROFILE = AutotuneProfile()
