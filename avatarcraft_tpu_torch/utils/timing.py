"""Kernel timings on the card: CUDA events around a warm loop, CUDA events
around each call with the L2 cache flushed before it, and the profiler's
device time of what a call launches in that cold loop. Needs a CUDA card;
nothing here runs at import."""

from __future__ import annotations

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

# written between timed calls to evict the caller's data from the 50 MB L2
FLUSH_BYTES = 256 * 2**20


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_cold(fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean milliseconds per call with the L2 cache flushed before each
    call (a FLUSH_BYTES write, outside the timed span): CUDA events around
    each call, summed."""
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    for _ in range(warmup):
        fn()
    spans = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for i, (start, end) in enumerate(spans):
        flush.fill_(float(i))
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in spans) / iters


# a short profile now and then records no device event at all, or misses
# some: such a profile is taken again, up to this many times
PROFILE_TRIES = 3


def _device_events(fn) -> list:
    """torch.profiler's device events (kernels and copies) of ``fn()``,
    which the profile waits for; a profile that recorded none is taken
    again, up to PROFILE_TRIES times."""
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events:
            break
    return events


def device_names(fn, calls: int = 10) -> list[str]:
    """The names of the kernels and copies that ``calls`` calls of ``fn``
    put on the card, in order, from torch.profiler."""
    return [e.name for e in _device_events(lambda: [fn() for _ in range(calls)])]


def cold_device_ms(fn, iters: int = 20, warmup: int = 2) -> tuple[float, list[str]]:
    """(device ms per call, names) of the kernels and copies ``fn``
    launches, in the loop of ``cuda_ms_cold`` (the L2 flushed before each
    call): torch.profiler's device events of that loop, less those of the
    flushes (the names a loop of flushes alone puts on the card). Raises if
    no profile of the loop holds all ``iters`` flushes."""
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    for _ in range(warmup):
        fn()
    flush_names = set(device_names(lambda: flush.fill_(0.0)))

    def loop():
        for i in range(iters):
            flush.fill_(float(i))
            fn()

    for _ in range(PROFILE_TRIES):
        events = _device_events(loop)
        if sum(e.name in flush_names for e in events) == iters:
            own = [e for e in events if e.name not in flush_names]
            return sum(e.time_range.elapsed_us() for e in own) / 1e3 / iters, sorted({e.name for e in own})
    raise RuntimeError(f"torch.profiler did not record the {iters} flushes of the cold loop")


def device_us_without(event, names) -> float:
    """Device microseconds that torch.profiler attributes to a host
    ``event`` and the ops under it, as its ``device_time_total`` counts
    them, leaving out the kernels named like any of ``names``. A kernel
    launched through ctypes is attributed to the op it runs under, and
    sometimes to two of them (the first launch in a profile is counted
    twice): count such a kernel by its own device events instead
    (``kernel_device_us``)."""
    return sum(k.duration for k in event.kernels if not any(n in k.name for n in names)) + sum(
        device_us_without(c, names) for c in event.cpu_children
    )


def kernel_device_us(events, name: str) -> float:
    """Device microseconds of the profiler's device events named like
    ``name``, each counted once."""
    return sum(e.time_range.elapsed_us() for e in events if e.device_type == DeviceType.CUDA and name in e.name)
