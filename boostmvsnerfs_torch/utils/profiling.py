"""Tracing and profiling of the port: spans, counters and the device trace
(counterpart of ``boostmvsnerfs_tpu/utils/profiling.py``).

``span(name)`` marks a layer's region of host time. Tracing is on while a
torch.profiler records or inside a ``collect()`` scope; there is no other
switch. While it is on, a span adds its host duration and one call to an
in-memory table keyed by its name, and under a recording profiler it is a
``record_function`` annotation too, so the span lies in the profiler's trace
on the device records' clock and the kernels it launches are correlated to
it. While tracing is off a span costs one flag check and returns a shared
no-op object: no annotation, no clock read, no allocation. Spans nest; a
span's self time is its duration less its direct children's. Names are
constant strings. ``spanned(name)`` is the decorator form.

``count(name, amount)`` adds to a counter of the registry. The registry's
totals always count (``counts``, ``reset_counts``: the CUDA wrappers'
``launches.<kernel>`` counts are read that way); the tables keep what each
counter counted while tracing was on.

``traced()`` returns the process's table of everything recorded while
tracing was on (``reset_traced`` empties it); ``collect()`` is a scope that
turns tracing on without a profiler and yields a table of its own, of what
every thread recorded inside it. The entries' timers read their spans that
way.

``device_trace`` writes a torch.profiler trace (Chrome / Perfetto JSON) of a
region. On the H100 machines torch.profiler drops the device records of a
profile's first kernels as lying outside its window (kineto's
"Out-of-range" count): the first one early in a process, more later, every
kernel of a 5-kernel profile by the end of a long run, and up to 8 of a
burst of spin kernels at a profile's start. So a profile on the card starts
with ``PRIMER_KERNELS`` spin kernels and ``PROFILE_LEAD_S`` of idle time
before the region it traces (``primed_profile``). Late in a long run the
primer does not always keep them: ``complete_profile`` raises
``LostRecords`` when a kernel launched in the region has no device record,
and ``profiled`` takes such a profile again, up to ``PROFILE_TRIES`` in all,
so every time read from its profile comes from one that kept them all.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from time import perf_counter_ns

import torch
from torch.profiler import record_function

PRIMER_KERNELS = 32
PROFILE_LEAD_S = 0.25
PROFILE_TAIL_S = 0.05
PROFILE_TRIES = 3

_profiler_enabled = torch._C._autograd._profiler_enabled


class Table:
    """Spans' calls, host and self nanoseconds, and counters' amounts, by
    name."""

    def __init__(self):
        self.spans: dict[str, list] = {}  # name -> [calls, host ns, self ns]
        self.counters: dict[str, int] = {}

    def add_span(self, name: str, ns: int, self_ns: int) -> None:
        entry = self.spans.setdefault(name, [0, 0, 0])
        entry[0] += 1
        entry[1] += ns
        entry[2] += self_ns

    def seconds(self, name: str) -> float:
        """The host seconds of span ``name`` over its calls (0 without one)."""
        return self.spans.get(name, (0, 0))[1] * 1e-9

    def as_dict(self) -> dict:
        return {"spans": {name: {"n": n, "host_s": ns * 1e-9, "self_s": self_ns * 1e-9}
                          for name, (n, ns, self_ns) in self.spans.items()},
                "counters": dict(self.counters)}


_lock = threading.Lock()
_totals: dict[str, int] = {}
_traced = Table()
_open: list[Table] = []  # the open collect() scopes' tables
_local = threading.local()  # .stack: this thread's open spans
_NO_SPAN = contextlib.nullcontext()  # every span while tracing is off


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    __slots__ = ("name", "annotation", "t0", "child_ns")

    def __init__(self, name: str):
        self.name = name
        self.child_ns = 0

    def __enter__(self):
        self.annotation = record_function(self.name) if _profiler_enabled() else None
        if self.annotation is not None:
            self.annotation.__enter__()
        _stack().append(self)
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = perf_counter_ns() - self.t0
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1].child_ns += ns
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        with _lock:
            for table in (_traced, *_open):
                table.add_span(self.name, ns, ns - self.child_ns)
        return False


def span(name: str):
    """A context manager over a layer's region: recorded while tracing is
    on (module docstring), a shared no-op while it is off."""
    if _open or _profiler_enabled():
        return _Span(name)
    return _NO_SPAN


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapper
    return decorate


def count(name: str, amount: int = 1) -> None:
    """Add ``amount`` to counter ``name``: to its total always, and to the
    tables while tracing is on."""
    with _lock:
        _totals[name] = _totals.get(name, 0) + amount
        if _open or _profiler_enabled():
            for table in (_traced, *_open):
                table.counters[name] = table.counters.get(name, 0) + amount


def counts() -> dict[str, int]:
    """Every counter's total since the process started or its reset."""
    with _lock:
        return dict(_totals)


def reset_counts(names) -> None:
    with _lock:
        for name in names:
            _totals[name] = 0


@contextlib.contextmanager
def collect():
    """Tracing on over the block without a profiler; yields the block's own
    ``Table``."""
    table = Table()
    with _lock:
        _open.append(table)
    try:
        yield table
    finally:
        with _lock:
            _open.remove(table)


def traced() -> dict:
    """Everything recorded while tracing was on: ``{"spans": {name: {"n",
    "host_s", "self_s"}}, "counters": {name: amount}}``."""
    with _lock:
        return _traced.as_dict()


def reset_traced() -> None:
    global _traced
    with _lock:
        _traced = Table()


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
    or None. The spans inside it are annotations of the trace."""
    if not logdir:
        yield None
        return
    os.makedirs(logdir, exist_ok=True)
    with primed_profile() as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.time_ns()}.json"))


class LostRecords(AssertionError):
    """torch.profiler kept no device record of a kernel launched in a
    ``complete_profile`` block (ROADMAP fault 12)."""


def lost_launches(prof) -> int:
    """Kernel launches of a ``primed_profile`` block (those after the
    primer's) whose kernel has no device record: launches and kernels pair
    by their correlation ids."""
    events = prof.profiler.kineto_results.events()
    recorded = {e.correlation_id() for e in events
                if e.device_type() == torch.autograd.DeviceType.CUDA}
    launches = sorted(e.correlation_id() for e in events
                      if e.device_type() == torch.autograd.DeviceType.CPU
                      and e.name().startswith(("cudaLaunch", "cuLaunch")))
    return sum(c not in recorded for c in launches[PRIMER_KERNELS:])


@contextlib.contextmanager
def complete_profile():
    """``primed_profile`` on the card over the block; raises ``LostRecords``
    when a kernel launched in the block has no device record."""
    with primed_profile(cuda=True) as prof:
        yield prof
    lost = lost_launches(prof)
    if lost:
        raise LostRecords(f"torch.profiler lost the device records of {lost} kernel launches")


def profiled(block) -> tuple:
    """``block()`` under ``complete_profile``, taken again when torch.profiler
    loses a record of it (each loss printed as a ``profile_retaken`` JSON
    line; up to PROFILE_TRIES profiles, then ``LostRecords``): (the complete
    profile, the last run's value)."""
    for attempt in range(1, PROFILE_TRIES + 1):
        try:
            with complete_profile() as prof:
                value = block()
            return prof, value
        except LostRecords as e:
            print(json.dumps({"phase": "profile_retaken", "attempt": attempt, "reason": str(e)}),
                  flush=True)
            if attempt == PROFILE_TRIES:
                raise


def block_kernels(prof) -> list:
    """The kernels of a ``primed_profile``'s block (the primer's spin
    kernels left out), from ``key_averages``."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.key]
