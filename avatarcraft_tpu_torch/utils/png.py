"""A minimal PNG writer (stdlib zlib + struct): 8-bit RGB or gray, one
IDAT chunk, filter 0 on every row."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 [H, W, 3] (RGB) or [H, W] (gray) image."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_png takes uint8 [H,W] or [H,W,3], got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    color_type = 2 if img.ndim == 3 else 0
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1
    ).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as fp:
        fp.write(b"\x89PNG\r\n\x1a\n")
        fp.write(_chunk(b"IHDR", header))
        fp.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        fp.write(_chunk(b"IEND", b""))


def integerify_img(img: np.ndarray) -> np.ndarray:
    """float [0,1] -> uint8 (reference: utils/utils.py:428-436)."""
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255.0).astype(np.uint8)
