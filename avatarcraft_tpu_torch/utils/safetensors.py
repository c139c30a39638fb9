"""The safetensors file format, read and written without the
``safetensors`` package (the card's machine does not have it).

A file is an unsigned 64-bit little-endian header length N, N bytes of a
JSON header, then the data. The header maps each tensor's name to its
``dtype``, ``shape`` and ``data_offsets`` ([begin, end), counted from the
first byte after the header); an optional ``__metadata__`` entry holds
strings. Every value is little-endian and C-contiguous.

``load_file`` returns CPU tensors. bfloat16 is read as 16-bit integers and
viewed as ``torch.bfloat16`` (numpy has no bf16). It refuses a header
whose spans leave the file, overlap, leave a gap, do not end where the
file ends, or do not match their dtype and shape.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

# the format's dtype names, as numpy reads them; BF16 as its 16 bits
NUMPY_DTYPES = {
    "F64": np.dtype("<f8"),
    "F32": np.dtype("<f4"),
    "F16": np.dtype("<f2"),
    "BF16": np.dtype("<i2"),
    "I64": np.dtype("<i8"),
    "I32": np.dtype("<i4"),
    "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"),
    "U8": np.dtype("u1"),
    "BOOL": np.dtype("?"),
}
TORCH_NAMES = {
    torch.float64: "F64",
    torch.float32: "F32",
    torch.float16: "F16",
    torch.bfloat16: "BF16",
    torch.int64: "I64",
    torch.int32: "I32",
    torch.int16: "I16",
    torch.int8: "I8",
    torch.uint8: "U8",
    torch.bool: "BOOL",
}
# the header's length is a u64, but no real header comes near this
MAX_HEADER_BYTES = 100 * 2**20


def read_header(path: str) -> tuple[dict, int]:
    """(the header's tensor entries, less ``__metadata__``; the offset of
    the data in the file)."""
    with open(path, "rb") as fp:
        head = fp.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: {len(head)} bytes, shorter than the header's length field")
        (n,) = struct.unpack("<Q", head)
        if n > MAX_HEADER_BYTES:
            raise ValueError(f"{path}: a header of {n} bytes")
        raw = fp.read(n)
    if len(raw) < n:
        raise ValueError(f"{path}: the header's {n} bytes run past the end of the file")
    try:
        header = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise ValueError(f"{path}: the header is not JSON ({exc})") from exc
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    header.pop("__metadata__", None)
    return header, 8 + n


def _spans(path: str, header: dict, data_bytes: int) -> list:
    """[(begin, end, name, numpy dtype, shape)] sorted by begin, checked
    to tile the data exactly."""
    spans = []
    for name, entry in header.items():
        try:
            dtype, shape, (begin, end) = NUMPY_DTYPES[entry["dtype"]], entry["shape"], entry["data_offsets"]
        except (KeyError, TypeError, ValueError) as exc:
            raise ValueError(f"{path}: tensor {name!r} has a malformed entry {entry!r}") from exc
        if not (isinstance(begin, int) and isinstance(end, int) and all(isinstance(d, int) and d >= 0
                                                                        for d in shape)):
            raise ValueError(f"{path}: tensor {name!r} has a malformed entry {entry!r}")
        if not 0 <= begin <= end <= data_bytes:
            raise ValueError(f"{path}: tensor {name!r} spans [{begin}, {end}) outside the {data_bytes} data bytes")
        if end - begin != int(np.prod(shape, dtype=np.int64)) * dtype.itemsize:
            raise ValueError(f"{path}: tensor {name!r} spans {end - begin} bytes, not its {entry['dtype']} "
                             f"shape {shape}")
        spans.append((begin, end, name, dtype, tuple(shape)))
    spans.sort(key=lambda s: (s[0], s[1]))
    at = 0
    for begin, end, name, _, _ in spans:
        if begin < at:
            raise ValueError(f"{path}: tensor {name!r} at [{begin}, {end}) overlaps the one before it")
        if begin > at:
            raise ValueError(f"{path}: the bytes [{at}, {begin}) before tensor {name!r} belong to no tensor")
        at = end
    if at != data_bytes:
        raise ValueError(f"{path}: the tensors end at data byte {at}, the file at {data_bytes}")
    return spans


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of the file, as CPU tensors in the header's order."""
    header, start = read_header(path)
    buf = np.fromfile(path, dtype=np.uint8, offset=start)
    spans = {s[2]: s for s in _spans(path, header, buf.size)}
    out = {}
    for name in header:
        begin, end, _, dtype, shape = spans[name]
        part = buf[begin:end]
        # a view needs the span aligned to its item; a mixed-dtype file may not be
        arr = (part if begin % dtype.itemsize == 0 else part.copy()).view(dtype).reshape(shape)
        t = torch.from_numpy(arr)
        out[name] = t.view(torch.bfloat16) if header[name]["dtype"] == "BF16" else t
    return out


def save_file(tensors: dict, path: str, metadata: dict | None = None) -> None:
    """Write ``tensors`` ({name: tensor}) in the given order, the header
    padded with spaces to 8 bytes, each tensor's bytes little-endian."""
    header: dict = {"__metadata__": dict(metadata)} if metadata else {}
    at = 0
    for name, t in tensors.items():
        if t.dtype not in TORCH_NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no safetensors name")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": TORCH_NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [at, at + n]}
        at += n
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as fp:
        fp.write(struct.pack("<Q", len(text)))
        fp.write(text)
        for t in tensors.values():  # one tensor's bytes at a time
            t = t.detach().to("cpu").contiguous()
            raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
            fp.write(raw.astype(raw.dtype.newbyteorder("<"), copy=False).tobytes())
