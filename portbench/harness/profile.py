"""The traced sub-window: torch.profiler over a few steady frames or steps,
and what the per-layer metrics read from it.

Frozen copies of the port's profiling workaround: torch.profiler on the H100
machines drops the device records of a profile's first kernels as lying
outside its window, so a profile starts with ``PRIMER_KERNELS`` spin kernels
and ``PROFILE_LEAD_S`` of idle time before the block it traces
(``primed_profile``), and a profile that still lost a kernel launch's record
is taken again, up to ``PROFILE_TRIES`` in all (``profiled``). A lost record
would make a kernel's time too small and its roofline share too large.

``summarize`` splits the block's device time as the port's smoke script
does: under cuDNN convolutions and batch norm (forward and backward, by the
aten op that launched the kernels), under each ported kernel (by kernel
name), and the rest, the glue.
"""

from __future__ import annotations

import contextlib
import time

import torch

PRIMER_KERNELS = 32
PROFILE_LEAD_S = 0.25
PROFILE_TAIL_S = 0.05
PROFILE_TRIES = 3
# aten ops whose device time is the networks' (cuDNN) work
CONV_OPS = ("aten::convolution", "aten::convolution_backward")
NORM_OPS = ("aten::batch_norm",)
TOP = 10


class LostRecords(RuntimeError):
    """torch.profiler kept no device record of a kernel launched in the block."""


@contextlib.contextmanager
def primed_profile():
    """torch.profiler (CPU and CUDA) over the block, primed as the module
    docstring says; yields the profile."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PRIMER_KERNELS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(PROFILE_LEAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_TAIL_S)


def lost_launches(prof) -> int:
    """Kernel launches after the primer's whose kernel has no device record
    (launches and kernels pair by their correlation ids)."""
    events = prof.profiler.kineto_results.events()
    recorded = {e.correlation_id() for e in events
                if e.device_type() == torch.autograd.DeviceType.CUDA}
    launches = sorted(e.correlation_id() for e in events
                      if e.device_type() == torch.autograd.DeviceType.CPU
                      and e.name().startswith(("cudaLaunch", "cuLaunch")))
    return sum(c not in recorded for c in launches[PRIMER_KERNELS:])


def profiled(block):
    """``block()`` under ``primed_profile``, taken again while the profile
    loses a record (up to ``PROFILE_TRIES``). Returns (profile, the block's
    host seconds, retakes)."""
    for attempt in range(PROFILE_TRIES):
        with primed_profile() as prof:
            t0 = time.perf_counter()
            block()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        lost = lost_launches(prof)
        if not lost:
            return prof, seconds, attempt
    raise LostRecords(f"torch.profiler lost {lost} kernel records in {PROFILE_TRIES} profiles")


def _merged(intervals: list) -> list:
    out = []
    for a, b, name in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b, name])
    return out


def summarize(prof, units: int, ported: tuple) -> dict:
    """The block's device work per unit (frame or step), in seconds: busy
    (the union of device intervals, primer left out), the device's span
    (from the block's first operation's start to its last one's end), under
    the networks' ops, each kernel by name, the ported kernels (those whose name holds
    ``<name>_kernel`` for a name in ``ported``) and the glue, the rest; and
    over the whole block the top device ops and the longest idle gaps, each
    named by the host's innermost op at the gap's middle."""
    events = [e for e in prof.events() if "spin_kernel" not in e.name]
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    intervals = _merged([(e.time_range.start, e.time_range.end, e.name) for e in dev])
    busy_us = sum(b - a for a, b, _ in intervals)
    by_op = {}
    for e in prof.key_averages():
        by_op[e.key] = by_op.get(e.key, 0.0) + e.device_time_total
    kernel_us = {}
    for e in dev:
        kernel_us[e.name] = kernel_us.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    ported_us = sum(v for n, v in kernel_us.items() if any(f"{k}_kernel" in n for k in ported))
    conv_us = sum(by_op.get(k, 0.0) for k in CONV_OPS)
    norm_us = sum(v for k, v in by_op.items() if k in NORM_OPS or k.endswith("batch_norm_backward"))
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    gaps = sorted(((start - end, (end + start) / 2) for (_, end, _), (start, _, _)
                   in zip(intervals, intervals[1:])), reverse=True)[:TOP]
    named = []
    for us, mid in gaps:
        inside = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
        name = min(inside, key=lambda e: e.time_range.end - e.time_range.start).name \
            if inside else "host: no op"
        named.append((us, name))
    top_ops = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:TOP]
    per = 1e-6 / units
    return {
        "units": units,
        "busy_s": busy_us * per,
        "span_s": (intervals[-1][1] - intervals[0][0]) * per if intervals else 0.0,
        "conv_s": conv_us * per,
        "norm_s": norm_us * per,
        "kernels_s": {k: v * per for k, v in kernel_us.items()},
        "ported_s": ported_us * per,
        "glue_s": (busy_us - conv_us - norm_us - ported_us) * per,
        "device_ops": [[name[:120], us * 1e-6] for name, us in top_ops],
        "idle_gaps": [[name[:120], us * 1e-6] for us, name in named],
        "busy_total_s": busy_us * 1e-6,
    }
