"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C launch function. It is compiled
with ``nvcc`` for ``sm_90a`` into its own shared library under
``boostmvsnerfs_torch/_build/`` (ignored by git), keyed by a hash of the
source, the shared ``csrc/*.cuh`` headers and the flags so an unchanged
kernel is never rebuilt, and bound with ``ctypes``. Nothing is built at
import: the first CUDA call of a wrapper builds its kernel, and
``build()`` compiles several at once (one ``nvcc`` process per source,
all started together).

Each wrapper calls ``count_launch`` exactly where it launches its kernel,
so a run can show which kernels the main path went through: the counts are
the ``launches.<kernel>`` counters of ``utils/profiling``'s registry, and
``launch_counts`` / ``reset_launch_counts`` read and zero them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from boostmvsnerfs_torch.utils import profiling

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
KERNELS = ("warp_variance", "img_sample", "enerf_head", "tri_sample", "renderer_mlp",
           "warp_variance_bwd", "img_sample_bwd", "conv_wgrad", "conv_dgrad")
# forward kernels that have no backward kernel (none in the JAX package
# either): their wrappers refuse autograd
NO_BACKWARD = ("enerf_head", "tri_sample", "renderer_mlp")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_COUNTERS = {name: f"launches.{name}" for name in KERNELS}
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def count_launch(name: str) -> None:
    profiling.count(_COUNTERS[name])


def reset_launch_counts() -> None:
    profiling.reset_counts(_COUNTERS.values())


def launch_counts() -> dict[str, int]:
    totals = profiling.counts()
    return {name: totals.get(counter, 0) for name, counter in _COUNTERS.items()}


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


@functools.lru_cache(maxsize=None)
def source_constant(name: str, const: str) -> int:
    """The value of ``constexpr int <const> = <value>;`` in ``csrc/<name>.cu``:
    a limit that the kernel's source sets and its wrapper checks before it
    builds anything."""
    m = re.search(rf"constexpr int {const} = (\d+);", (CSRC / f"{name}.cu").read_text())
    if m is None:
        raise RuntimeError(f"csrc/{name}.cu defines no constexpr int {const}")
    return int(m.group(1))


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, keyed by its source, the shared
    headers of ``csrc/`` and the flags."""
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in sources) + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _run_all(jobs) -> list[str]:
    """Start every ``(label, cmd, log path)`` job at once and wait for all;
    returns the labels of those that failed."""
    procs = []
    for label, cmd, log in jobs:
        with open(log, "w") as f:
            procs.append((label, log, subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)))
    rcs = [(label, log, p.wait()) for label, log, p in procs]
    return [f"{label} (rc {rc}, log {log})" for label, log, rc in rcs if rc]


def build(names=KERNELS) -> None:
    """Compile every named kernel that is not built yet, all in parallel.
    The compiler's report (registers, spills) goes to ``_build/<lib>.log``."""
    libs = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not libs:
        return
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    failed = _run_all([
        (name, [nvcc(), *NVCC_FLAGS, "-shared", "-o", f"{lib}.{tag}", str(CSRC / f"{name}.cu")],
         lib.with_suffix(".log"))
        for name, lib in libs.items()
    ])
    if failed:
        raise RuntimeError("nvcc failed: " + ", ".join(failed))
    for lib in libs.values():
        os.replace(f"{lib}.{tag}", lib)


def kernel_function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C launch function ``symbol`` of kernel ``name``, building and
    loading its library and declaring its arguments once: a wrapper's host
    path adds to every launch, and a small grid runs in less time than it."""
    fn = _fns.get((name, symbol))
    if fn is not None:
        return fn
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name, symbol] = fn
    return fn


def check(name: str, rc: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")


def check_inputs(name: str, device: torch.device, dtype=torch.float32, **tensors) -> None:
    """Shared wrapper checks: one CUDA device, ``dtype`` (float32 unless
    said), contiguous and 16-byte aligned. A wrapper is called on tensors that need no gradient:
    ``warp_variance`` and ``img_sample`` get theirs through the autograd
    Functions around them (``*_diff``), the others have no backward."""
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(
                f"{name}: the CUDA wrappers are not differentiable; call it under "
                "torch.no_grad(), or use fused_warp_variance_diff / fused_row_sample_diff "
                f"for gradients ({', '.join(NO_BACKWARD)} have no backward kernel)"
            )


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card: the grid of a persistent kernel."""
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


def stream_ptr(device: torch.device) -> int:
    # by index: resolving a torch.device costs microseconds per launch
    return torch.cuda.current_stream(device.index).cuda_stream
