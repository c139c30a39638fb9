"""Read the JAX package's orbax checkpoints without orbax, tensorstore or a
zstd package: the card's machine has none of them.

An orbax ``StandardCheckpointer`` directory holds:

* ``_CHECKPOINT_METADATA`` (JSON; its handler is checked) and
  ``_METADATA`` (JSON): ``tree_metadata`` maps every leaf's key path to
  its keys (``key_type`` 2 a dict key, 1 a sequence index) and its
  ``value_type`` ("np.ndarray", "jax.Array", "scalar", or the empty
  containers "None", "List" and "Dict");
* an OCDBT key-value store (tensorstore's B-tree format): ``manifest.ocdbt``
  at the root names the latest version's root node; nodes and values live
  in data files under ``d/`` and ``ocdbt.process_<i>/d/``, which the root's
  nodes name by path;
* in that store, one zarr v2 array per array leaf, named by its keys joined
  with ".": ``<name>/.zarray`` (JSON metadata) and its chunks
  ``<name>/<i>.<j>...`` (``<name>/0`` for a scalar), each a zstd frame.

OCDBT files (manifest magic 0x0cdb3a2a, node magic 0x0cdb20de) are a
header (magic big-endian u32, total length u64le, version varint,
compression varint: 0 none, 1 zstd), the body, then a crc32c (not checked:
the standard library has no crc32c; a truncated or corrupt file fails the
length check or the zstd frame's own). Varints are LEB128. A data file
table is num_files, the shared-prefix lengths of files 1.., the suffix
lengths, the base-path lengths, then the suffixes. A node is its height, a
data file table, num_entries, the keys (shared-prefix lengths of entries
1.., suffix lengths, for an interior node the subtree-common-prefix
lengths, then the suffixes), then per entry in columns: for a leaf the
value length and kind (0 inline, 1 in a data file) and, for values in a
file, the file id and offset, then the inline values; for an interior
node the child's file id, offset and length and three counts.

zstd decodes through the system's ``libzstd.so.1`` (ctypes, its streaming
API: orbax's nodes carry no content size); a missing library raises, there
is no other route.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import json
import os
import struct

import numpy as np
import torch

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NO_ROOT = (1 << 64) - 1  # the root offset and length of an empty version

# ---------------------------------------------------------------------------
# zstd through the system library
# ---------------------------------------------------------------------------


class _Buffer(ctypes.Structure):
    # ZSTD_inBuffer and ZSTD_outBuffer: {const void* / void* ptr; size_t size; size_t pos}
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


@functools.cache
def libzstd():
    """The system's libzstd, bound once. Raises where it is missing."""
    name = ctypes.util.find_library("zstd")
    if name is None:
        raise RuntimeError("libzstd (libzstd.so.1) was not found: orbax checkpoints need it to be read")
    lib = ctypes.CDLL(name)
    lib.ZSTD_createDCtx.restype = ctypes.c_void_p
    lib.ZSTD_createDCtx.argtypes = []
    lib.ZSTD_freeDCtx.restype = ctypes.c_size_t
    lib.ZSTD_freeDCtx.argtypes = [ctypes.c_void_p]
    lib.ZSTD_decompressStream.restype = ctypes.c_size_t
    lib.ZSTD_decompressStream.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Buffer), ctypes.POINTER(_Buffer)]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
    lib.ZSTD_versionNumber.restype = ctypes.c_uint
    lib.ZSTD_versionNumber.argtypes = []
    return lib


def zstd_route() -> str:
    """Which zstd decoder runs: the library and its version."""
    v = libzstd().ZSTD_versionNumber()
    return f"{ctypes.util.find_library('zstd')} (ctypes), zstd {v // 10000}.{v // 100 % 100}.{v % 100}"


def zstd_decompress(src: bytes, size_hint: int = 0) -> bytes:
    """The content of the zstd frames in ``src`` (one or more, back to
    back). ``size_hint``: the expected size, the first output buffer's."""
    lib = libzstd()
    dctx = lib.ZSTD_createDCtx()
    if not dctx:
        raise MemoryError("ZSTD_createDCtx failed")
    try:
        src = bytes(src)
        inb = _Buffer(ctypes.cast(ctypes.c_char_p(src), ctypes.c_void_p), len(src), 0)  # src outlives the call
        out = bytearray(max(size_hint, 1 << 12))
        pos = 0
        while True:
            if pos == len(out):
                out.extend(bytes(len(out)))
            view = (ctypes.c_char * (len(out) - pos)).from_buffer(out, pos)
            outb = _Buffer(ctypes.addressof(view), len(out) - pos, 0)
            ret = lib.ZSTD_decompressStream(dctx, ctypes.byref(outb), ctypes.byref(inb))
            del view
            if lib.ZSTD_isError(ret):
                raise ValueError(f"zstd: {lib.ZSTD_getErrorName(ret).decode()}")
            pos += outb.pos
            if inb.pos == inb.size:
                if ret == 0:
                    return bytes(memoryview(out)[:pos])
                if outb.pos < outb.size:  # all input read, the frame unfinished
                    raise ValueError("zstd: truncated frame")
    finally:
        lib.ZSTD_freeDCtx(dctx)


# ---------------------------------------------------------------------------
# OCDBT
# ---------------------------------------------------------------------------


class _Cursor:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def varint(self) -> int:
        value = shift = 0
        while True:
            byte = self.data[self.pos]
            self.pos += 1
            value |= (byte & 0x7F) << shift
            shift += 7
            if byte < 0x80:
                return value

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def byte(self) -> int:
        self.pos += 1
        return self.data[self.pos - 1]

    def take(self, n: int) -> bytes:
        self.pos += n
        if self.pos > len(self.data):
            raise ValueError("OCDBT: record runs past its end")
        return self.data[self.pos - n:self.pos]

    def done(self) -> bool:
        return self.pos == len(self.data)


def _envelope(raw: bytes, magic: int, what: str) -> _Cursor:
    """The body of a manifest or node file, decompressed."""
    if len(raw) < 16 or struct.unpack(">I", raw[:4])[0] != magic:
        raise ValueError(f"OCDBT {what}: bad magic")
    if struct.unpack("<Q", raw[4:12])[0] != len(raw):
        raise ValueError(f"OCDBT {what}: length {len(raw)} differs from its header's")
    head = _Cursor(raw[:len(raw) - 4])
    head.pos = 12
    if head.varint() != 0:
        raise ValueError(f"OCDBT {what}: unknown format version")
    compression = head.varint()
    body = raw[head.pos:len(raw) - 4]
    if compression == 1:
        body = zstd_decompress(body)
    elif compression != 0:
        raise ValueError(f"OCDBT {what}: unknown compression {compression}")
    return _Cursor(body)


def _prefixed_strings(c: _Cursor, n: int, prefix_lens: list, suffix_lens: list) -> list:
    out, prev = [], b""
    for i in range(n):
        s = (prev[:prefix_lens[i - 1]] if i else b"") + c.take(suffix_lens[i])
        out.append(s)
        prev = s
    return out


def _data_file_table(c: _Cursor) -> list:
    """The file paths (relative to the store's root) a record refers to."""
    n = c.varint()
    prefix = c.varints(max(n - 1, 0))
    suffix = c.varints(n)
    c.varints(n)  # base-path lengths: the paths are read whole
    return [p.decode() for p in _prefixed_strings(c, n, prefix, suffix)]


class _Files:
    """Data files of one store, opened once each."""

    def __init__(self, root: str):
        self.root, self.handles = root, {}

    def read(self, path: str, offset: int, length: int) -> bytes:
        if path not in self.handles:
            self.handles[path] = open(os.path.join(self.root, path), "rb")
        fp = self.handles[path]
        fp.seek(offset)
        data = fp.read(length)
        if len(data) != length:
            raise ValueError(f"OCDBT: {path} ends before {offset} + {length}")
        return data

    def close(self):
        for fp in self.handles.values():
            fp.close()


def _latest_root(root: str):
    """(path, offset, length) of the latest version's root node, or None for
    an empty store, from ``manifest.ocdbt``."""
    with open(os.path.join(root, "manifest.ocdbt"), "rb") as fp:
        c = _envelope(fp.read(), MANIFEST_MAGIC, "manifest")
    c.take(16)  # uuid
    if c.varint() != 0:
        raise NotImplementedError("OCDBT: only the single-file manifest is read")
    c.varint(), c.varint()  # max inline value bytes, max decoded node bytes
    c.byte()  # version tree arity (log2)
    if c.varint() == 1:  # zstd: its level
        c.take(4)
    paths = _data_file_table(c)
    n = c.varint()  # the inline versions, oldest first; the latest is last
    if n == 0:
        return None
    c.varints(n)  # generation numbers
    c.take(n)  # root heights
    fid, off, length = c.varints(n), c.varints(n), c.varints(n)
    if off[-1] == _NO_ROOT:
        return None
    return paths[fid[-1]], off[-1], length[-1]


def read_ocdbt(root: str) -> dict:
    """Every key of the OCDBT store at ``root`` -> its value (bytes)."""
    files = _Files(root)
    out = {}

    def visit(path, offset, length, prefix):
        c = _envelope(files.read(path, offset, length), NODE_MAGIC, "node")
        height = c.byte()
        paths = _data_file_table(c)
        n = c.varint()
        prefix_lens, suffix_lens = c.varints(max(n - 1, 0)), c.varints(n)
        common = c.varints(n) if height > 0 else None
        keys = _prefixed_strings(c, n, prefix_lens, suffix_lens)
        if height > 0:
            fid, off, ln = c.varints(n), c.varints(n), c.varints(n)
            c.varints(3 * n)  # num keys, tree bytes, indirect value bytes
            if not c.done():
                raise ValueError("OCDBT: interior node longer than its entries")
            for i in range(n):
                visit(paths[fid[i]], off[i], ln[i], prefix + keys[i][:common[i]])
            return
        value_lens, kinds = c.varints(n), c.varints(n)
        n_out = sum(1 for k in kinds if k == 1)
        fid, off = c.varints(n_out), c.varints(n_out)
        j = 0
        for key, vlen, kind in zip(keys, value_lens, kinds):
            if kind == 0:
                out[(prefix + key).decode()] = c.take(vlen)
            elif kind == 1:
                out[(prefix + key).decode()] = files.read(paths[fid[j]], off[j], vlen)
                j += 1
            else:
                raise ValueError(f"OCDBT: unknown value kind {kind}")
        if not c.done():
            raise ValueError("OCDBT: leaf node longer than its entries")

    try:
        ref = _latest_root(root)
        if ref is not None:
            visit(*ref, b"")
    finally:
        files.close()
    return out


# ---------------------------------------------------------------------------
# zarr v2 arrays
# ---------------------------------------------------------------------------


def read_zarr_array(store: dict, name: str):
    """The zarr v2 array ``name`` of ``store`` (key -> bytes): a numpy array,
    or for bfloat16 (which numpy lacks) a CPU ``torch.bfloat16`` tensor.
    Chunks are assembled in C order; a missing chunk is the fill value
    (zero where it is null)."""
    meta = json.loads(store[f"{name}/.zarray"])
    if meta.get("zarr_format") != 2 or meta.get("order", "C") != "C" or meta.get("filters"):
        raise NotImplementedError(f"{name}: only C-order zarr v2 arrays without filters are read")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise NotImplementedError(f"{name}: compressor {compressor.get('id')!r} (orbax writes zstd)")
    bf16 = meta["dtype"] == "bfloat16"
    dtype = np.dtype("<u2") if bf16 else np.dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    fill = 0 if meta.get("fill_value") is None else meta["fill_value"]
    if bf16:  # the fill's bit pattern
        fill = int(torch.tensor(float(fill), dtype=torch.bfloat16).view(torch.int16).item()) & 0xFFFF
    out = np.full(shape, fill, dtype=dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for idx in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        if key not in store:
            continue
        raw = store[key]
        if compressor is not None:
            raw = zstd_decompress(raw, chunk_bytes)
        block = np.frombuffer(raw, dtype=dtype).reshape(chunks)
        sel = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sel] = block[tuple(slice(0, t.stop - t.start) for t in sel)]
    if bf16:
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


# ---------------------------------------------------------------------------
# The checkpoint's tree
# ---------------------------------------------------------------------------

_EMPTY = {"None": lambda: None, "List": list, "Dict": dict}


def restore(path: str):
    """The tree of the orbax checkpoint directory ``path`` as
    ``ocp.StandardCheckpointer().restore(path)`` returns it without a
    target: dicts for dict keys (named tuples included), lists for sequence
    indices, the empty containers and None where they were saved; array
    leaves as numpy arrays ("jax.Array" ones too: the port has no JAX;
    bfloat16 as CPU torch tensors), "scalar" leaves as Python numbers."""
    with open(os.path.join(path, "_CHECKPOINT_METADATA")) as fp:
        handler = json.load(fp).get("item_handlers")
    if handler is not None and not str(handler).endswith("StandardCheckpointHandler"):
        raise NotImplementedError(f"{path}: orbax handler {handler!r}; only StandardCheckpointer's is read")
    with open(os.path.join(path, "_METADATA")) as fp:
        meta = json.load(fp)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise NotImplementedError(f"{path}: only OCDBT checkpoints with zarr v2 arrays are read")
    store = read_ocdbt(path)
    root: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        vtype = entry["value_metadata"]["value_type"]
        if vtype in _EMPTY:
            leaf = _EMPTY[vtype]()
        elif vtype in ("np.ndarray", "jax.Array", "scalar"):
            leaf = read_zarr_array(store, ".".join(str(k["key"]) for k in keys))
            if vtype == "scalar":
                leaf = leaf.item()
        else:
            raise NotImplementedError(f"{path}: leaf type {vtype!r}")
        node = root
        for k, nxt in zip(keys[:-1], keys[1:]):
            node = node.setdefault(_key(k), _Seq() if nxt["key_type"] == 1 else {})
        node[_key(keys[-1])] = leaf
    return _finish(root)


class _Seq(dict):
    """A sequence's items by index while the tree is built."""


def _key(k: dict):
    return int(k["key"]) if k["key_type"] == 1 else str(k["key"])


def _finish(node):
    """The built tree with its sequences as lists."""
    if isinstance(node, _Seq):
        return [_finish(node[i]) for i in sorted(node)]
    if isinstance(node, dict):
        return {k: _finish(v) for k, v in node.items()}
    return node


def restore_like(tree, like):
    """``tree``'s leaves in the structure of ``like`` (dicts, named tuples,
    lists and tuples; None stays None), as orbax's restore with a target
    returns them: a leaf missing from ``tree`` raises KeyError."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: restore_like(_child(tree, k), v) for k, v in like.items()}
    if hasattr(like, "_fields"):  # a named tuple: saved under its field names
        return type(like)(*(restore_like(_child(tree, f), getattr(like, f)) for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(restore_like(_child(tree, i), v) for i, v in enumerate(like))
    return tree


def _child(tree, key):
    try:
        return tree[key] if isinstance(tree, list) else tree[str(key)]
    except (KeyError, IndexError, TypeError):
        raise KeyError(f"the checkpoint has no leaf at {key!r}") from None
