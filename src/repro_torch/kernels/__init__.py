"""Hand-written CUDA kernels for Hopper, each beside its plain version.

Importing this package builds nothing: a kernel compiles at its first
CUDA launch (:mod:`repro_torch.kernels._build`).
"""
