"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C launch function. It is compiled
with ``nvcc`` for ``sm_90a`` into its own shared library under
``boostmvsnerfs_torch/_build/`` (ignored by git), keyed by a hash of the
source and the flags so an unchanged kernel is never rebuilt, and bound
with ``ctypes``. Nothing is built at import: the first CUDA call of a
wrapper builds its kernel, and ``build()`` compiles several at once (one
``nvcc`` process per source, all started together).

Each wrapper calls ``count_launch`` exactly where it launches its kernel,
so a run can show which kernels the main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
KERNELS = ("warp_variance", "img_sample", "enerf_head")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_launches = dict.fromkeys(KERNELS, 0)
_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def count_launch(name: str) -> None:
    _launches[name] += 1


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(_launches)


def nvcc() -> str:
    """Path of ``nvcc``; raises when the CUDA toolkit is missing."""
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (searched PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
        "the CUDA kernels of boostmvsnerfs_torch are built from source at "
        "first use and need the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names=KERNELS) -> None:
    """Compile every named kernel that is not built yet, all in parallel.
    The compiler's report (registers, spills) goes to ``_build/<lib>.log``."""
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, out, log))
    failed = []
    for name, proc, tmp, out, log in jobs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name} (rc {rc}, log {out.with_suffix('.log')})")
    if failed:
        raise RuntimeError("nvcc failed: " + ", ".join(failed))


def kernel_function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C launch function ``symbol`` of kernel ``name``, building and
    loading its library on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, rc: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")


def check_inputs(name: str, device: torch.device, **tensors) -> None:
    """Shared wrapper checks: one CUDA device, float32, contiguous, 16-byte
    aligned, and no autograd (the kernels have no backward yet)."""
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(f"{name}: the CUDA kernel has no backward; call it under torch.no_grad()")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
