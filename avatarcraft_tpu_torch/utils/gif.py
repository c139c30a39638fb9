"""Animated GIFs and the JET colormap without imageio, cv2 or PIL (the
card's machine has none of them): numpy and the standard library.

``write_gif`` is the port's ``imageio.mimsave(path, frames, fps=fps,
loop=0)``, which the JAX package's render CLIs call
(cli/render_canonical_cli.py:251-253, cli/render_warp_cli.py:154-158):
GIF89a, the NETSCAPE2.0 application block with the loop count, and per
frame a graphic control block with its delay, a local palette of at most
256 colours fitted to the frame, and its LZW-coded indices. A frame of at
most 256 colours is stored exactly; a richer one through a median cut of
its colours weighted by their pixel counts, each colour then mapped to its
nearest palette entry. The delays are what imageio's pillow writer stores:
1000 / fps ms a frame, a run of equal consecutive frames stored once with
their durations added, cut to whole hundredths of a second (so the warp
CLI's forward-and-back GIF of n frames holds 2n - 1). The palette is not
PIL's (ROADMAP queue 3): the CPU tests hold the port's frames at most one
level further from the PNGs than the JAX package's GIF is.

``jet_colormap`` is ``cv2.applyColorMap(gray, cv2.COLORMAP_JET)``, level
for level, in cv2's BGR channel order.
"""

from __future__ import annotations

import struct

import numpy as np

_LZW_MAX_CODE = 4095  # 12-bit codes


def gif_delay_cs(fps: float, repeats: int = 1) -> int:
    """The delay in hundredths of a second that imageio's pillow writer
    stores for ``repeats`` equal consecutive frames at ``fps``: their
    durations of 1000 / fps ms added one by one, cut to whole hundredths
    (6 at 15 fps, 10 at 10 fps)."""
    ms = 0.0
    for _ in range(repeats):
        ms += 1000.0 / fps
    return int(ms / 10)


def _median_cut(colors: np.ndarray, counts: np.ndarray, n: int) -> np.ndarray:
    """[n', 3] uint8 palette (n' <= n) of the unique ``colors`` [U, 3]
    weighted by ``counts``: boxes split at the weighted median of their
    widest channel, the widest box first; each entry its box's weighted
    mean."""

    def box(members):
        spread = np.ptp(colors[members], axis=0)
        return int(spread.max()), int(spread.argmax()), members

    boxes = [box(np.arange(len(colors)))]
    while len(boxes) < n:
        widest = max(range(len(boxes)), key=lambda i: boxes[i][0])
        if boxes[widest][0] == 0:
            break
        _, ch, members = boxes.pop(widest)
        members = members[np.argsort(colors[members, ch], kind="stable")]
        cum = np.cumsum(counts[members])
        cut = int(np.clip(np.searchsorted(cum, cum[-1] / 2.0), 1, len(members) - 1))
        boxes += [box(members[:cut]), box(members[cut:])]
    return np.stack([
        np.round((colors[m] * counts[m, None]).sum(0) / counts[m].sum()) for _, _, m in boxes
    ]).astype(np.uint8)


def _nearest(colors: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """The index of each colour's nearest palette entry (squared RGB
    distance, the first of ties): |p|^2 - 2 c.p, exact in float64 for
    8-bit levels."""
    pal = palette.astype(np.float64)
    return ((pal * pal).sum(1)[None, :] - 2.0 * colors.astype(np.float64) @ pal.T).argmin(1)


def quantize(frame: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(indices [H, W] uint8, palette [256, 3] uint8) of an [H, W, 3] uint8
    frame: its own colours when it has at most 256, else a median-cut
    palette."""
    flat = frame.reshape(-1, 3)
    key = (flat[:, 0].astype(np.int64) << 16) | (flat[:, 1].astype(np.int64) << 8) | flat[:, 2]
    uniq, inverse, counts = np.unique(key, return_inverse=True, return_counts=True)
    colors = np.stack([(uniq >> 16) & 255, (uniq >> 8) & 255, uniq & 255], axis=1)
    if len(colors) <= 256:
        palette, lookup = colors.astype(np.uint8), np.arange(len(colors))
    else:
        palette = _median_cut(colors, counts, 256)
        lookup = _nearest(colors, palette)
    full = np.zeros((256, 3), np.uint8)
    full[: len(palette)] = palette
    return lookup[inverse.reshape(-1)].astype(np.uint8).reshape(frame.shape[:2]), full


def lzw_encode(indices: np.ndarray) -> bytes:
    """GIF's variable-width LZW of 8-bit ``indices`` (minimum code size 8):
    codes from 9 to 12 bits, packed least significant bit first, a clear
    code first and whenever the table is full, an end code last."""
    clear, end = 256, 257
    out, acc, nbits = bytearray(), 0, 0
    size = 9

    def emit(code: int) -> None:
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    table: dict = {}
    next_code = end + 1
    emit(clear)
    data = indices.reshape(-1).tolist()
    if data:
        prefix = data[0]
        for c in data[1:]:
            key = (prefix, c)
            code = table.get(key)
            if code is not None:
                prefix = code
                continue
            emit(prefix)
            if next_code <= _LZW_MAX_CODE:
                table[key] = next_code
                next_code += 1
                if next_code - 1 == 1 << size and size < 12:
                    size += 1
            else:
                emit(clear)
                table.clear()
                next_code, size = end + 1, 9
            prefix = c
        emit(prefix)
    emit(end)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i : i + 255])]) + data[i : i + 255] for i in range(0, len(data), 255)) + b"\0"


def write_gif(path: str, frames, fps: float, loop: int = 0) -> None:
    """Write ``frames`` ([H, W, 3] uint8 each, one size) as an animated
    GIF at ``fps`` that plays ``loop`` times (0: forever)."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("write_gif needs at least one frame")
    h, w = frames[0].shape[:2]
    for f in frames:
        if f.dtype != np.uint8 or f.shape != (h, w, 3):
            raise ValueError(f"write_gif takes [H, W, 3] uint8 frames of one size, got {f.dtype} {f.shape}")
    runs = []  # [frame, repeats]: equal consecutive frames stored once
    for f in frames:
        if runs and np.array_equal(runs[-1][0], f):
            runs[-1][1] += 1
        else:
            runs.append([f, 1])
    parts = [b"GIF89a", struct.pack("<HHBBB", w, h, 0x70, 0, 0),
             b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\0"]
    for f, repeats in runs:
        idx, palette = quantize(f)
        parts += [
            # keep the frame, no transparency
            b"\x21\xf9\x04\x04" + struct.pack("<H", gif_delay_cs(fps, repeats)) + b"\0\0",
            b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87),  # a local palette of 256 entries
            palette.tobytes(),
            b"\x08" + _sub_blocks(lzw_encode(idx)),
        ]
    with open(path, "wb") as fp:
        fp.write(b"".join(parts) + b"\x3b")


def gif_info(path: str) -> dict:
    """The block structure of a GIF: {"version", "width", "height", "loop"
    (None without a NETSCAPE2.0 block), "delays" (hundredths of a second,
    one per frame), "frames"}; raises on a malformed file."""
    with open(path, "rb") as fp:
        data = fp.read()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path}: not a GIF")
    w, h, flags = struct.unpack("<HHB", data[6:11])
    pos = 13 + (3 * (2 << (flags & 7)) if flags & 0x80 else 0)
    info = {"version": data[:6].decode(), "width": w, "height": h, "loop": None, "delays": [], "frames": 0}
    delay = None

    def skip_sub_blocks(p: int) -> tuple[int, list]:
        blocks = []
        while data[p]:
            blocks.append(data[p + 1 : p + 1 + data[p]])
            p += 1 + data[p]
        return p + 1, blocks

    while pos < len(data):
        tag = data[pos]
        if tag == 0x3B:
            return info
        if tag == 0x21:
            label = data[pos + 1]
            pos, blocks = skip_sub_blocks(pos + 2)
            if label == 0xFF and blocks and blocks[0] == b"NETSCAPE2.0":
                info["loop"] = struct.unpack("<H", blocks[1][1:3])[0]
            elif label == 0xF9:
                delay = struct.unpack("<H", blocks[0][1:3])[0]
        elif tag == 0x2C:
            flags = data[pos + 9]
            pos += 10 + (3 * (2 << (flags & 7)) if flags & 0x80 else 0)
            pos, _ = skip_sub_blocks(pos + 1)
            info["frames"] += 1
            info["delays"].append(delay)
            delay = None
        else:
            raise ValueError(f"{path}: unknown block 0x{tag:02x} at byte {pos}")
    raise ValueError(f"{path}: no trailer")


def _jet_table() -> np.ndarray:
    """cv2's COLORMAP_JET as [256, 3] uint8 BGR: each channel a ramp of 4
    levels a step between 0 and 255 (red from level 96, green from 32, blue
    from 128 at level 0, each falling again 64 levels after it saturates);
    cv2 rounds its float knots, which gives blue 1 at level 159 where the
    ramp gives 2."""
    i = np.arange(256)
    r = np.minimum(4 * i - 382, 1148 - 4 * i)
    g = np.minimum(4 * i - 128, 892 - 4 * i)
    b = np.minimum(4 * i + 128, 638 - 4 * i)
    b[159] = 1
    return np.clip(np.stack([b, g, r], axis=1), 0, 255).astype(np.uint8)


JET_BGR = _jet_table()


def jet_colormap(gray: np.ndarray) -> np.ndarray:
    """``cv2.applyColorMap(gray, cv2.COLORMAP_JET)`` of uint8 ``gray``
    ([H, W] or [H, W, 1]): [H, W, 3] uint8 in cv2's BGR order."""
    gray = np.asarray(gray)
    if gray.dtype != np.uint8:
        raise ValueError(f"jet_colormap takes uint8 levels, got {gray.dtype}")
    if gray.ndim == 3 and gray.shape[-1] == 1:
        gray = gray[..., 0]
    return JET_BGR[gray]
