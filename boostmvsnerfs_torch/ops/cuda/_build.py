"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C launch function. It is compiled
with ``nvcc`` for ``sm_90a`` into its own shared library under
``boostmvsnerfs_torch/_build/`` (ignored by git), keyed by a hash of the
source, the flags and its units so an unchanged kernel is never rebuilt,
and bound with ``ctypes``. A source with slow template instances is
compiled as several translation units (``UNITS``: one set of ``-D``
flags each) and linked into the one library. Nothing is built at import:
the first CUDA call of a wrapper builds its kernel, and ``build()``
compiles several at once (one ``nvcc`` process per unit, all started
together).

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
KERNELS = ("warp_variance", "img_sample", "enerf_head", "tri_sample", "renderer_mlp",
           "warp_variance_bwd", "img_sample_bwd")
# forward kernels that have no backward kernel (none in the JAX package
# either): their wrappers refuse autograd
NO_BACKWARD = ("enerf_head", "tri_sample", "renderer_mlp")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Translation units of a source, one set of -D flags each (default: one
# unit, no flags). enerf_head's four fully unrolled (S, C, view-dir)
# instances build in parallel, with the dispatcher as a fifth unit.
UNITS = {"enerf_head": tuple((f"-DENERF_HEAD_UNIT={i}",) for i in range(5))}

_launches = dict.fromkeys(KERNELS, 0)
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}
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


def units(name: str) -> tuple:
    return UNITS.get(name, ((),))


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
        + repr(units(name)).encode()
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
    """Compile every named kernel that is not built yet: all their units in
    parallel, then one link per library. The compiler's report (registers,
    spills) of all units goes to ``_build/<lib>.log``."""
    libs = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not libs:
        return
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    # nvcc tells an object from a source by its suffix: keep ".o" last
    objs = {name: [lib.with_name(f"{lib.stem}.{i}.{os.getpid()}.o") for i in range(len(units(name)))]
            for name, lib in libs.items()}
    logs = {name: [lib.with_name(f"{lib.stem}.{i}.log") for i in range(len(units(name)))]
            for name, lib in libs.items()}
    failed = _run_all([
        (f"{name} unit {i}",
         [nvcc(), *NVCC_FLAGS, *defines, "-c", "-o", str(objs[name][i]), str(CSRC / f"{name}.cu")],
         logs[name][i])
        for name in libs for i, defines in enumerate(units(name))
    ])
    if failed:
        raise RuntimeError("nvcc failed: " + ", ".join(failed))
    failed = _run_all([
        (f"{name} link", [nvcc(), *ARCH, "-shared", "-o", f"{lib}.{tag}", *map(str, objs[name])],
         lib.with_suffix(".link.log"))
        for name, lib in libs.items()
    ])
    if failed:
        raise RuntimeError("nvcc link failed: " + ", ".join(failed))
    for name, lib in libs.items():
        lib.with_suffix(".log").write_text("".join(log.read_text() for log in logs[name]))
        for path in (*objs[name], *logs[name], lib.with_suffix(".link.log")):
            path.unlink()
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


def check_inputs(name: str, device: torch.device, **tensors) -> None:
    """Shared wrapper checks: one CUDA device, float32, contiguous and
    16-byte aligned. A wrapper is called on tensors that need no gradient:
    ``warp_variance`` and ``img_sample`` get theirs through the autograd
    Functions around them (``*_diff``), the others have no backward."""
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
            raise RuntimeError(
                f"{name}: the CUDA wrappers are not differentiable; call it under "
                "torch.no_grad(), or use fused_warp_variance_diff / fused_row_sample_diff "
                f"for gradients ({', '.join(NO_BACKWARD)} have no backward kernel)"
            )


def stream_ptr(device: torch.device) -> int:
    # by index: resolving a torch.device costs microseconds per launch
    return torch.cuda.current_stream(device.index).cuda_stream
