"""Serving layer: parameter sweeps and the index content fingerprint."""
from repro_torch.serve.store import index_fingerprint  # noqa: F401
from repro_torch.serve.sweep import (  # noqa: F401
    SweepResult, grid_sweep, sweep, sweep_stats,
)
