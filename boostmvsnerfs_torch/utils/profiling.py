"""Profiling utilities (counterpart of ``boostmvsnerfs_tpu/utils/profiling.py``;
reference lib/utils/net_utils.py:31-70 ``perf_timer``).

``perf_timer`` brackets a region with ``torch.cuda.synchronize`` on a CUDA
device, as the reference does; ``device_trace`` writes a torch.profiler
trace (Chrome / Perfetto JSON) of a region; ``annotate`` names a region in
such a trace.

On the H100 machines torch.profiler drops the device records of a profile's
first kernels as lying outside its window (kineto's "Out-of-range" count):
the first one early in a process, more later, every kernel of a 5-kernel
profile by the end of a long run, and up to 8 of a burst of spin kernels at
a profile's start. So a profile on the card starts with ``PRIMER_KERNELS``
spin kernels and ``PROFILE_LEAD_S`` of idle time before the region it
traces (``primed_profile``), which kept every record of the region in every
profile taken so far.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

PRIMER_KERNELS = 32
PROFILE_LEAD_S = 0.25
PROFILE_TAIL_S = 0.05


class perf_timer:
    """Wall timer that waits for the card at both ends when ``device`` is
    CUDA (by default: when a CUDA device is present).

    >>> with perf_timer("render") as t:
    ...     out = fn(x)
    >>> t.elapsed  # seconds
    """

    def __init__(self, name: str = "", enabled: bool = True, device=None):
        self.name = name
        self.enabled = enabled
        self.cuda = (torch.device(device).type == "cuda" if device is not None
                     else torch.cuda.is_available())
        self.elapsed = 0.0

    def sync(self, out=None):
        """Wait for the card's queued work; returns ``out``."""
        if self.cuda:
            torch.cuda.synchronize()
        return out

    def __enter__(self):
        self.sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sync()
        self.elapsed = time.perf_counter() - self._t0
        if self.enabled and self.name:
            print(f"[perf] {self.name}: {self.elapsed * 1e3:.2f} ms")
        return False


@contextlib.contextmanager
def primed_profile(cuda: bool | None = None):
    """torch.profiler over the block (CPU, and CUDA when ``cuda``; by
    default when a CUDA device is present), the card's records primed as
    the module docstring says; yields the profile. The primer's launches
    come first in the profile."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() if cuda is None else cuda
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        if cuda:
            for _ in range(PRIMER_KERNELS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(PROFILE_LEAD_S)
        yield prof
        if cuda:
            torch.cuda.synchronize()
            time.sleep(PROFILE_TAIL_S)


@contextlib.contextmanager
def device_trace(logdir: str | None):
    """``primed_profile`` over the block, written to
    ``<logdir>/trace_<ns>.json`` (Chrome trace format: open it in Perfetto or
    chrome://tracing); a no-op when ``logdir`` is falsy. Yields the profile,
    or None."""
    if not logdir:
        yield None
        return
    os.makedirs(logdir, exist_ok=True)
    with primed_profile() as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.time_ns()}.json"))


def annotate(name: str):
    """Named region for a trace (torch.profiler's ``record_function``)."""
    return torch.profiler.record_function(name)
