"""Step timing, traces and a metrics stream: the port of the JAX package's
utils/profiling.py:24-93 (the reference has none).

* ``StepTimer``: the wall time of each step, the first ``skip`` (warm-up)
  steps left out, and its EMA. On the card a step is timed with CUDA events
  on the current stream (the end event waited for), on the CPU with the
  host clock.
* ``trace``: ``torch.profiler`` over a block, written to ``logdir`` as a
  Chrome / TensorBoard trace (``*.pt.trace.json``).
* ``annotate``: a named range inside a trace (``record_function``).
* ``MetricsLogger``: an append-only JSONL stream.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler


class StepTimer:
    """Each step's seconds after the first ``skip``, and their EMA."""

    def __init__(self, skip: int = 1, ema: float = 0.9, device=None):
        self.skip = skip
        self.ema = ema
        self.n = 0
        self.avg = None
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._t0 = None

    def start(self) -> None:
        if self.cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self, sync_value=None) -> float | None:
        """End the step; returns its seconds (None in the warm-up).
        ``sync_value`` (a loss, say) is read to the host first, as the
        JAX package reads it; on the card the end event is waited for."""
        if sync_value is not None and hasattr(sync_value, "__float__"):
            float(sync_value)
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            dt = self._t0.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - self._t0
        self.n += 1
        if self.n <= self.skip:
            return None
        self.avg = dt if self.avg is None else self.ema * self.avg + (1 - self.ema) * dt
        return dt

    def rate(self, units_per_step: float = 1.0) -> float:
        return units_per_step / self.avg if self.avg else 0.0


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True):
    """torch.profiler over the block (the card's kernels too where there is
    one), written to ``logdir`` as a Chrome / TensorBoard trace."""
    if not enabled:
        yield None
        return
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def annotate(name: str):
    """A named range inside a trace (host side)."""
    return record_function(name)


class MetricsLogger:
    """An append-only JSONL metrics stream (rays/s, steps/s, loss, PSNR)."""

    def __init__(self, path: str | None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")
        else:
            self._fh = None

    def log(self, step: int, **metrics) -> dict:
        rec = {"step": step, "time": time.time(), **metrics}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec

    def close(self) -> None:
        if self._fh:
            self._fh.close()
