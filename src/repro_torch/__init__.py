"""PyTorch port of the SCAN engine, for NVIDIA Hopper (H100).

A sibling of the JAX package ``repro``, which stays the reference: this
package imports ``torch`` and numpy only, never ``jax`` and nothing of
``repro``. Module layout and names follow the reference so each port
module sits beside its counterpart:

* :mod:`repro_torch.core` — CSR graph, degree-bucketed σ, GS*-Index,
  (μ, ε) queries, quality measures and the sequential oracle;
* :mod:`repro_torch.kernels` — the hand-written CUDA kernels
  (``bucket_probe``, ``masked_gram``), each beside its plain PyTorch
  version, plus their ``nvcc`` → ``ctypes`` build step;
* :mod:`repro_torch.backend` — lanes (``ref`` / ``hopper``), the
  autotune profile and padding helpers;
* :mod:`repro_torch.serve` — parameter sweeps and the content fingerprint;
* :mod:`repro_torch.interop` — numpy dicts in and out, for handing state
  across the two packages.

Device rule: entry points that create tensors take ``device=None``, which
means ``cuda``, and raise when CUDA is absent; pass ``device="cpu"`` to run
on the CPU. Everything downstream follows the graph's device. Importing
the package builds nothing and touches no GPU: kernels compile at their
first CUDA launch.
"""
