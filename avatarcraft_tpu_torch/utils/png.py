"""Minimal PNG I/O on the standard library (zlib + struct), for a machine
without imageio: a writer (8-bit RGB or gray, one IDAT chunk, filter 0 on
every row) and a reader of 8-bit RGB and RGBA images that are not
interlaced, with the five row filters (PNG specification, section 9)."""

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


_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha", 6: "RGBA"}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """[H, 1 + stride] filtered scanlines -> [H, stride] bytes."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:  # None
            cur = line
        elif ftype == 1:  # Sub: a running sum per byte lane, mod 256
            lanes = line.reshape(-1, bpp).astype(np.int64)
            cur = (np.cumsum(lanes, axis=0) % 256).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prior  # uint8 wraps mod 256
        elif ftype in (3, 4):  # Average, Paeth: each byte needs the one bpp before it
            x, up, vals = line.tolist(), prior.tolist(), [0] * stride
            for i in range(stride):
                left = vals[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                vals[i] = (x[i] + pred) & 255
            cur = np.asarray(vals, np.uint8)
        else:
            raise ValueError(f"PNG row {y} has the unknown filter type {ftype}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit RGB or RGBA PNG that is not interlaced: uint8 [H, W, 3]
    or [H, W, 4], as imageio reads it. Any other PNG raises a ValueError
    that names its format."""
    with open(path, "rb") as fp:
        data = fp.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + n]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, color, compression, filtering, interlace = header
    if depth != 8 or color not in (2, 6) or interlace or compression or filtering:
        kind = _COLOR_TYPES.get(color, f"color type {color}")
        raise ValueError(
            f"{path}: a {depth}-bit {kind} PNG{' (interlaced)' if interlace else ''}; "
            "read_png reads 8-bit RGB or RGBA PNGs that are not interlaced"
        )
    bpp = 3 if color == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: {raw.size} bytes of image data for a {w}x{h} {_COLOR_TYPES[color]} PNG")
    return _unfilter(raw.reshape(h, 1 + w * bpp), bpp).reshape(h, w, bpp)
