"""The yardstick's arithmetic: the card's published peaks, the model FLOPs
of a step (counted over the plain reference's own step, from its shapes)
and the HBM bytes of the K10 kernels' calls (each input read once, each
output written once, from the call's shapes)."""

from __future__ import annotations

import torch

# NVIDIA's data sheet for the H100 SXM part, dense rates without sparsity:
# float32 outside the tensor cores, TF32, bf16; HBM3 bytes per second
H100 = {"f32_flops": 67e12, "tf32_flops": 495e12, "bf16_flops": 989e12, "hbm_bytes": 3.35e12}


def peaks(device_name: str) -> dict | None:
    """The published peaks of the card called ``device_name`` (None for a
    card the table does not hold: no share of a peak is then reported)."""
    return H100 if "H100" in device_name else None


def count_flops(fn) -> tuple[object, int]:
    """(fn(), the FLOPs of the matrix products and convolutions it ran,
    forward and backward, as torch.utils.flop_counter counts them from
    their shapes: 2 per multiply-add)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn()
    return out, int(counter.get_total_flops())


def gather_bytes(rows: int, cols: int, itemsize: int) -> int:
    """HBM bytes of one all-gather of a [rows, cols] table: the shards read
    once, the table written once."""
    return 2 * rows * cols * itemsize


def reduce_scatter_bytes(rows: int, cols: int, m: int = 1) -> int:
    """HBM bytes of one reduce-scatter of m f32 cotangents [rows, cols]:
    each read once, the shards' sum written once."""
    return (m + 1) * rows * cols * 4


def roofline_share(bytes_moved: float, device_s: float, hbm_bytes_per_s: float) -> float | None:
    """Percent of the HBM bound: the time the bytes need at the peak rate
    over the device time they took (None without a device time)."""
    if device_s <= 0.0:
        return None
    return 100.0 * bytes_moved / hbm_bytes_per_s / device_s


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
