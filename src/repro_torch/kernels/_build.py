"""Build the port's CUDA kernels and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own, with ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), under ``build/repro_torch/`` at the repository root. The file
name carries a hash of the source and the flags, so an edited source never
loads a stale library. Several sources build in parallel: one ``nvcc``
process each, all started together.

Nothing here runs at import time. The first CUDA launch of a kernel
builds and loads its library; a missing ``nvcc`` or a CUDA-less process
raises, and no caller falls back to a plain version.

Launch counts: each wrapper calls :func:`check_launch` right after its
kernel launched, and nowhere else, so a run can show that its path went
through the kernels.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("bucket_probe", "masked_gram", "hamming_cosine", "simhash_pack")


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    name: str
    path: str
    seconds: float        # wall time of this build (0.0 when reused)
    ptxas: List[str]      # `-Xptxas -v` lines: registers, shared memory


_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_INFO: Dict[str, BuildInfo] = {}
_LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def nvcc_path() -> str:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in ("nvcc", os.path.join(cuda_home, "bin", "nvcc")):
        found = shutil.which(cand)
        if found:
            return found
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build only where the CUDA "
        "toolkit is installed")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Sequence[str] = KERNELS) -> Dict[str, BuildInfo]:
    """Compile (or reuse) the named kernels' libraries; one ``nvcc`` per
    source, all running at once. Returns each kernel's :class:`BuildInfo`."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: cannot build the kernels")
    with _LOCK:
        todo = [n for n in names if n not in _INFO]
        if todo:
            _build_locked(todo)
        return {n: _INFO[n] for n in names}


def _build_locked(names: Sequence[str]) -> None:
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            _INFO[name] = BuildInfo(name, str(out), 0.0, [])
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)     # atomic: a concurrent loader sees all or none
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "ptxas info" in ln and ("Used" in ln or "Function" in ln)]
        _INFO[name] = BuildInfo(name, str(out), seconds, ptxas)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of kernel ``name``, built and loaded
    on first use, with ``argtypes`` set and an ``int`` (cudaError_t)
    result."""
    if name not in _LIBS:
        info = build([name])[name]
        with _LOCK:
            _LIBS.setdefault(name, ctypes.CDLL(info.path))
    fn = getattr(_LIBS[name], symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_launch(name: str, err: int) -> None:
    """Raise on a launch error the C side returned (``cudaGetLastError``);
    otherwise count the launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    _LAUNCHES[name] += 1
