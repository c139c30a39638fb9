"""What the metric readers share: times of the untraced window, the
device's idle share and launches in the CUDA-only trace, device time
under the program's ranges in the full trace, the share of the card's
peak of the window's model FLOPs, the K10 kernels' share of their HBM
bound. Each returns None where the run holds nothing to read.

A ``--trace 1`` run reads its window untraced first, then traces a short
window of the card's activity alone (the profiler adds little to a
launch), then one with the host's ranges too (for the time under a
range). Rates and host times are the untraced window's; idle shares and
launches the CUDA-only trace's."""

from __future__ import annotations

from portbench import counts, trace


def per_unit(units: int, total: float | None) -> float | None:
    if total is None or not units:
        return None
    return total / units


def window_ms(view) -> float | None:
    """Milliseconds of the window over the steps or frames it completed."""
    return per_unit(view.units, view.window_s * 1e3)


def named_range_ms(view, name: str) -> float | None:
    """Device ms a unit under the program's host ranges called ``name``, in
    the full trace."""
    full = view.full
    if full is None:
        return None
    us = trace.named_range_device_us(full.events, name)
    return None if us is None else per_unit(full.units, us / 1e3)


def idle_share(view) -> float | None:
    """Percent of the CUDA-only traced window in which no operation ran on
    the card."""
    t = view.cuda
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us / 1e6 / t.window_s)


def kernel_launches(view) -> float | None:
    """Kernels on the card a unit in the CUDA-only trace (copies and fills
    left out), graph replays' kernels included."""
    t = view.cuda
    if t is None:
        return None
    n = sum(1 for e in t.dev_events if not e.name.startswith(("Memcpy", "Memset")))
    return per_unit(t.units, float(n))


def mfu(view) -> float | None:
    """Percent of the card's f32 peak: the model FLOPs of the units the
    untraced window completed over its length."""
    peak = counts.peaks(view.device_name)
    flops = getattr(view.job, "flops_per_unit", None)
    if peak is None or not flops or not view.units or view.window_s <= 0:
        return None
    return 100.0 * flops * view.units / view.window_s / peak["f32_flops"]


def k10_roofline(view) -> float | None:
    """Percent of the HBM bound of both K10 kernels in the CUDA-only trace:
    their calls' bytes (inputs read once, outputs written once, from the
    table's shape) at the peak rate over their device time by name."""
    peak = counts.peaks(view.device_name)
    shape = getattr(view.job, "k10_shape", None)
    t = view.cuda
    if t is None or peak is None or shape is None:
        return None
    rows, cols = shape
    n_gather = t.counters.get("all_gather_rows", 0)
    n_rs = t.counters.get("reduce_scatter_rows", 0)
    us = sum(trace.kernel_device_us(t.dev_events, k) for k in trace.K10_KERNELS)
    if not (n_gather or n_rs) or us <= 0:
        return None
    moved = n_gather * counts.gather_bytes(rows, cols, 4) + n_rs * counts.reduce_scatter_bytes(rows, cols)
    return counts.roofline_share(moved, us / 1e6, peak["hbm_bytes"])
