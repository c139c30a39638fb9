"""Image metrics: a copy of the JAX package's utils/metrics.py (numpy only)."""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    """Peak signal-to-noise ratio between two images in [0, max_val]."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(max_val**2 / mse))


def integerify_img(img: np.ndarray) -> np.ndarray:
    """float [0,1] -> uint8 (reference: utils/utils.py:428-436)."""
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255.0).astype(np.uint8)
