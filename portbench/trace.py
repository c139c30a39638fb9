"""Reading torch.profiler's record of a window: the device's kernels and
copies, the union of their intervals (``busy_us``), a kernel's device time
by name, the device time under a program range, and the breakdown (the
device operations that took most time, the longest idle gaps by the host
range open during them).

``busy_us``, ``kernel_device_us`` and ``device_us_without`` are copies of
the port's ``utils/timing.py`` arithmetic: the benchmark's yardstick does not
move when the program's copies do."""

from __future__ import annotations

from torch.autograd import DeviceType

# the port's K10 kernels are launched through ctypes: the profiler ties them
# to the ops around them once, twice or not at all, so they are counted by
# their own device events, each once
K10_GATHER = "gather_rows_kernel"
K10_REDUCE_SCATTER = "reduce_scatter_rows_kernel"
K10_KERNELS = (K10_GATHER, K10_REDUCE_SCATTER)
TOP = 10  # entries in each list of the breakdown


def host_names(events) -> frozenset:
    return frozenset(e.name for e in events if e.device_type == DeviceType.CPU)


def device_events(events) -> list:
    """The profile's kernels and copies: the device's copies of host ranges
    carry a host event's name; kernels never do."""
    host = host_names(events)
    return [e for e in events if e.device_type == DeviceType.CUDA and e.name not in host]


def busy_us(dev_events) -> float:
    """Microseconds in which at least one of ``dev_events`` ran: the union
    of their intervals (kernels on other streams overlap)."""
    total, end = 0.0, float("-inf")
    for e in sorted(dev_events, key=lambda e: e.time_range.start):
        start, stop = e.time_range.start, e.time_range.end
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def kernel_device_us(dev_events, name: str) -> float:
    """Device microseconds of the device events named like ``name``, each
    counted once."""
    return sum(e.time_range.elapsed_us() for e in dev_events if name in e.name)


def device_us_without(event, names, host_names=frozenset()) -> float:
    """Device microseconds that the profiler attributes to a host ``event``
    and the ops under it, leaving out the kernels named like any of
    ``names`` and the device's copies of host ranges (``host_names``: a
    range's annotation on the device timeline spans all its kernels)."""
    return sum(k.duration for k in event.kernels
               if k.name not in host_names and not any(n in k.name for n in names)) + sum(
        device_us_without(c, names, host_names) for c in event.cpu_children
    )


def named_range_device_us(events, name: str) -> float | None:
    """Device microseconds under every host range called ``name`` (the
    kernels launched inside it on any thread that ran it), None when the
    profile holds no such range."""
    found = [e for e in events if e.device_type == DeviceType.CPU and e.name == name]
    if not found:
        return None
    # a range nested in another of the same name is counted once
    outer = [e for e in found if not _has_ancestor(e, name)]
    host = host_names(events)
    return sum(device_us_without(e, (), host) for e in outer)


def _has_ancestor(event, name: str) -> bool:
    p = event.cpu_parent
    while p is not None:
        if p.name == name:
            return True
        p = p.cpu_parent
    return False


def breakdown(events, dev_events, spans=()) -> dict:
    """{"device_ops": [[name, seconds], ...], "idle_gaps": [[name, seconds],
    ...]}: the device operations that took most time, summed by name, and
    the device's idle time summed by what the host was doing: the
    innermost host range (the program's, or the benchmark's ``spans``,
    (name, start_us, end_us)) open when each gap began, else "host"."""
    by_name: dict = {}
    for e in dev_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    host = [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == DeviceType.CPU and "." in e.name and not e.name.startswith(("aten::", "cuda"))]
    host = sorted(host + list(spans), key=lambda h: h[1])
    gaps: dict = {}
    end, nxt, active = None, 0, []
    for e in sorted(dev_events, key=lambda e: e.time_range.start):
        start = e.time_range.start
        if end is not None and start > end:
            # the host ranges open at ``end`` (which only grows): a sweep
            while nxt < len(host) and host[nxt][1] <= end:
                active.append(host[nxt])
                nxt += 1
            active = [h for h in active if h[2] >= end]
            key = min(active, key=lambda h: h[2] - h[1])[0] if active else "host"
            gaps[key] = gaps.get(key, 0.0) + (start - end)
        end = e.time_range.end if end is None else max(end, e.time_range.end)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n[:120], us / 1e6] for n, us in ops],
            "idle_gaps": [[n[:120], us / 1e6] for n, us in idle]}
