"""The comparison that decides ``correct``.

Training cells: the witness of a run is, per step the reference follows,
its loss; per trained parameter (by name), the norm of its gradient as the
optimizer holds it (Adam's first moment after the first call: a graphed
scan's first call holds several steps) and the norm of its change over
those steps. Each gap is taken by the worst parameter: the distance
between the program's norm and the reference's, over the larger of the
reference's norm of that parameter and of the median parameter's.
Parameters whose reference gradient is under a thousandth of the median's
move under Adam by round-off alone: they are left out of the change, by
that rule and not by name.

Frames: the widest gap of a pixel between the program's answers and the
reference's, over a sample of the frames that the window finished.
"""

from __future__ import annotations

import math
import statistics

import torch

# a parameter is counted in the change when its reference gradient is at
# least this share of the median parameter's
MOVED_SHARE = 1e-3


def leaf_norms(tensors) -> list[float]:
    """The f64 norm of each tensor (one read of the device)."""
    if not tensors:
        return []
    return [float(v) for v in torch.stack([t.detach().double().norm() for t in tensors]).cpu()]


def leaf_gaps(got: dict, ref: dict, keep=None) -> list[tuple[float, str]]:
    """(gap, name) of each counted parameter, the widest first: the
    distance between the norms over the larger of the reference's norm of
    the parameter and of the median counted parameter. A parameter that
    one side lacks reads infinity."""
    if set(got) != set(ref):
        return [(math.inf, "?")]
    names = [n for n in ref if keep is None or keep[n]]
    if not names:
        return [(math.inf, "?")]
    median = statistics.median(ref[n] for n in names)
    gaps = []
    for n in names:
        scale = max(ref[n], median)
        gap = abs(got[n] - ref[n]) / scale if scale > 0 else (0.0 if got[n] == ref[n] else math.inf)
        gaps.append((gap if gap == gap else math.inf, n))
    return sorted(gaps, reverse=True)


def compare_training(got: dict, ref: dict) -> dict:
    """{"loss": the worst relative loss gap over the steps, "grad": the
    worst parameter's gradient-norm gap, "change": the worst counted
    parameter's change-norm gap}. A non-finite number reads infinity."""
    if len(got["losses"]) != len(ref["losses"]):
        loss = math.inf
    else:
        loss = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(got["losses"], ref["losses"]))
        loss = loss if loss == loss else math.inf
    median = statistics.median(ref["grad"].values())
    keep = {n: g >= MOVED_SHARE * median for n, g in ref["grad"].items()}
    return {"loss": loss, "grad": leaf_gaps(got["grad"], ref["grad"])[0][0],
            "change": leaf_gaps(got["change"], ref["change"], keep)[0][0]}


def compare_frames(got: dict, ref: dict) -> dict:
    """{"image": the widest gap of a pixel channel over the frames of
    ``ref`` (a dict frame index -> image)}. The reference works out each
    frame's body transforms itself, so a wrong transform is a wrong
    image."""
    image = 0.0
    for k, r in ref.items():
        g = got.get(k)
        if g is None or g.shape != r.shape:
            return {"image": math.inf}
        d = (torch.as_tensor(g, dtype=torch.float64) - torch.as_tensor(r, dtype=torch.float64)).abs()
        image = max(image, float(d.max()) if d.isfinite().all() else math.inf)
    return {"image": image}


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(every number within its limit, [(name, number, limit), ...]). A
    number without a limit, or a limit without a number, fails."""
    rows = []
    ok = set(numbers) == set(limits)
    for name in sorted(set(numbers) | set(limits)):
        value, limit = numbers.get(name, math.inf), limits.get(name, -math.inf)
        ok = ok and value <= limit
        rows.append((name, value, limit))
    return ok, rows
