"""Pinhole camera intrinsics (replaces cameras/pinhole_camera.py +
cameras/captures.py of the reference -- the capture-class lattice collapses to
a plain dataclass; resizing scales focal/center, reference:
cameras/pinhole_camera.py:50-57)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float

    @property
    def shape(self) -> tuple[int, int]:
        return (self.height, self.width)

    @property
    def intrinsic(self) -> np.ndarray:
        return intrinsic_matrix(self.fx, self.fy, self.cx, self.cy)

    def resized(self, tgt_hw: tuple[int, int]) -> "PinholeCamera":
        h, w = tgt_hw
        sh, sw = h / self.height, w / self.width
        return PinholeCamera(
            int(w), int(h), self.fx * sw, self.fy * sh, self.cx * sw, self.cy * sh
        )


def intrinsic_matrix(fx: float, fy: float, cx: float, cy: float) -> np.ndarray:
    return np.array(
        [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=np.float32
    )
