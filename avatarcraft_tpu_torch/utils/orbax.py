"""Read and write the JAX package's orbax checkpoints without orbax,
tensorstore, a zstd or a crc32c package: the card's machine has none of
them.

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
compression varint: 0 none, 1 zstd), the body, then the crc32c
(Castagnoli) of all that precedes it, u32le, which the reader checks.
Varints are LEB128. A data file table is num_files, the shared-prefix
lengths of files 1.., the suffix lengths, the base-path lengths, then the
suffixes. A node is its height, a data file table, num_entries, the keys
(shared-prefix lengths of entries 1.., suffix lengths, for an interior
node the subtree-common-prefix lengths, then the suffixes), then per entry
in columns: for a leaf the value length and kind (0 inline, 1 in a data
file) and, for values in a file, the file id and offset, then the inline
values; for an interior node the child's file id, offset and length and
three counts (keys, node bytes and out-of-line value bytes of its
subtree). A child's keys drop the first subtree-common-prefix bytes of
its parent's entry.

The writer (``save``, ``write_ocdbt``) writes what orbax's restore reads:
one store at the directory's root (orbax also keeps the per-process store
``ocdbt.process_0/`` it merged from; its restore does not read it), with
one data file of the values over 1024 bytes and the nodes, a leaf node
and interior nodes only where a node would pass 100,000,000 decoded
bytes, and each array one zarr chunk of its whole shape, zstd level 1.

zstd runs through the system's ``libzstd.so.1`` (ctypes; the streaming
decoder, as orbax's nodes carry no content size); a missing library
raises, there is no other route. Compression is host work, as
tensorstore's is for the JAX package.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import json
import os
import shutil
import struct
import time
import uuid

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
        raise RuntimeError("libzstd (libzstd.so.1) was not found: orbax checkpoints need it to be read or written")
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
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    lib.ZSTD_createCCtx.argtypes = []
    lib.ZSTD_freeCCtx.restype = ctypes.c_size_t
    lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
    lib.ZSTD_CCtx_setParameter.restype = ctypes.c_size_t
    lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ZSTD_compress2.restype = ctypes.c_size_t
    lib.ZSTD_compress2.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t]
    return lib


def zstd_route() -> str:
    """Which zstd decoder runs: the library and its version."""
    v = libzstd().ZSTD_versionNumber()
    return f"{ctypes.util.find_library('zstd')} (ctypes), zstd {v // 10000}.{v // 100 % 100}.{v % 100}"


_ZSTD_C_COMPRESSION_LEVEL, _ZSTD_C_NB_WORKERS = 100, 400  # ZSTD_cParameter
ZSTD_THREADED_MIN_BYTES = 1 << 22  # smaller inputs are one job of zstd's anyway


def zstd_compress(data, level: int = 1) -> bytes:
    """One zstd frame of ``data`` (any buffer: bytes, a contiguous numpy
    array) at ``level`` (orbax's zarr arrays record level 1; 0 is the
    library's default). From ZSTD_THREADED_MIN_BYTES on, zstd's own worker
    threads compress it, one a host core, where the library was built with
    them (4.0x to 4.3x faster than one thread over a 0.92 GB train state
    on an H100 machine's 8 host cores, ``profile_checkpoint``); the frame
    decodes as any other."""
    lib = libzstd()
    src = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) else data.reshape(-1).view(np.uint8)
    out = np.empty(lib.ZSTD_compressBound(src.size), np.uint8)
    cctx = lib.ZSTD_createCCtx()
    if not cctx:
        raise MemoryError("ZSTD_createCCtx failed")
    try:
        ret = lib.ZSTD_CCtx_setParameter(cctx, _ZSTD_C_COMPRESSION_LEVEL, level)
        if not lib.ZSTD_isError(ret) and src.size >= ZSTD_THREADED_MIN_BYTES:
            # an error here is a library built without threads: it compresses alone
            lib.ZSTD_CCtx_setParameter(cctx, _ZSTD_C_NB_WORKERS, os.cpu_count() or 1)
        if not lib.ZSTD_isError(ret):
            ret = lib.ZSTD_compress2(cctx, out.ctypes.data, out.size, src.ctypes.data, src.size)
    finally:
        lib.ZSTD_freeCCtx(cctx)
    if lib.ZSTD_isError(ret):
        raise ValueError(f"zstd: {lib.ZSTD_getErrorName(ret).decode()}")
    return out[:ret].tobytes()


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
# crc32c
# ---------------------------------------------------------------------------


def _crc32c_table() -> list:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """The CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) of
    ``data``, table-driven: OCDBT checksums its manifests and nodes, which
    are small, with it."""
    crc, table = 0xFFFFFFFF, _CRC32C
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ---------------------------------------------------------------------------
# OCDBT
# ---------------------------------------------------------------------------

MAX_INLINE_VALUE_BYTES = 1024  # orbax's OCDBT configuration
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


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
    if crc32c(raw[:-4]) != struct.unpack("<I", raw[-4:])[0]:
        raise ValueError(f"OCDBT {what}: crc32c mismatch")
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


def _varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append(n & 0x7F | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _varints(ns) -> bytes:
    return b"".join(_varint(n) for n in ns)


def _sealed(body: bytes, magic: int) -> bytes:
    """A manifest or node file: the header, ``body`` zstd-compressed, the
    crc32c."""
    head = _varint(0) + _varint(1)  # format version 0, zstd
    packed = zstd_compress(body, 0)
    raw = struct.pack(">I", magic) + struct.pack("<Q", 12 + len(head) + len(packed) + 4) + head + packed
    return raw + struct.pack("<I", crc32c(raw))


def _common_prefix(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _key_columns(keys: list) -> tuple:
    """(shared-prefix lengths of keys 1.., suffix lengths, suffixes)."""
    prefix = [_common_prefix(keys[i - 1], keys[i]) for i in range(1, len(keys))]
    starts = [0] + prefix
    return prefix, [len(k) - s for k, s in zip(keys, starts)], b"".join(k[s:] for k, s in zip(keys, starts))


def _file_table_bytes(paths: list) -> bytes:
    if not paths:
        return _varint(0)
    keys = [p.encode() for p in paths]
    prefix, suffix, tail = _key_columns(keys)
    return _varint(len(keys)) + _varints(prefix) + _varints(suffix) + _varints([0] * len(keys)) + tail


def _groups(sizes: list, limit: int, least: int) -> list:
    """Consecutive index ranges whose sizes sum to at most ``limit`` (at
    least ``least`` items each, the last range's items allowing)."""
    out, start, total = [], 0, 0
    for i, s in enumerate(sizes):
        if i - start >= least and total + s > limit:
            out.append((start, i))
            start, total = i, 0
        total += s
    out.append((start, len(sizes)))
    return out


def write_ocdbt(root: str, items) -> int:
    """Write an OCDBT store of ``items`` (a mapping, or an iterable of
    (key, bytes) pairs, keys str or bytes) at ``root`` in orbax's
    configuration: one data file ``d/<uuid>`` holding every value over 1024
    bytes (written as the pairs come) and then the nodes, leaves of the
    keys in bytewise order and interior nodes only where a node's decoded
    size would pass MAX_DECODED_NODE_BYTES; then ``manifest.ocdbt`` with
    one version. Returns the bytes written."""
    max_node_bytes = MAX_DECODED_NODE_BYTES
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    data_path = f"d/{uuid.uuid4().hex}"
    entries = []  # (key, value length, inline value or None, offset)
    with open(os.path.join(root, data_path), "wb") as fp:
        offset = 0
        for key, value in items.items() if hasattr(items, "items") else items:
            key = key.encode() if isinstance(key, str) else bytes(key)
            if len(value) > MAX_INLINE_VALUE_BYTES:
                fp.write(value)
                entries.append((key, len(value), None, offset))
                offset += len(value)
            else:
                entries.append((key, len(value), bytes(value), 0))
        entries.sort(key=lambda e: e[0])
        if any(a[0] == b[0] for a, b in zip(entries, entries[1:])):
            raise ValueError("OCDBT: a key was given twice")

        def put(body: bytes) -> tuple:
            nonlocal offset
            raw = _sealed(body, NODE_MAGIC)
            fp.write(raw)
            offset += len(raw)
            return offset - len(raw), len(raw)

        def leaf_body(group: list, strip: int) -> bytes:
            keys = [e[0][strip:] for e in group]
            prefix, suffix, tail = _key_columns(keys)
            out = [bytes([0]), _file_table_bytes([data_path] if any(e[2] is None for e in group) else []),
                   _varint(len(group)), _varints(prefix), _varints(suffix), tail,
                   _varints(e[1] for e in group), _varints(0 if e[2] is not None else 1 for e in group)]
            far = [e for e in group if e[2] is None]
            out += [_varints([0] * len(far)), _varints(e[3] for e in far)]
            out += [e[2] for e in group if e[2] is not None]
            return b"".join(out)

        def interior_body(group: list, height: int, strip: int) -> bytes:
            # group: children (first key, last key, common prefix, offset, length, keys, tree bytes, value bytes)
            keys = [c[0][strip:] for c in group]
            prefix, suffix, tail = _key_columns(keys)
            return b"".join([bytes([height]), _file_table_bytes([data_path]), _varint(len(group)),
                             _varints(prefix), _varints(suffix), _varints(c[2] - strip for c in group), tail,
                             _varints([0] * len(group))] + [_varints(c[i] for c in group) for i in range(3, 8)])

        root_ref = None
        if entries:
            # the nodes bottom-up: each a child of the level above (its keys
            # stripped of their common prefix) until one node is left, the
            # root, whose keys are whole
            sizes = [len(e[0]) + (e[1] if e[2] is not None else 0) + 24 for e in entries]
            level = [entries[a:b] for a, b in _groups(sizes, max_node_bytes, 1)]
            height = 0
            while True:
                children = []
                for group in level:
                    first, last = group[0][0], group[-1][0 if height == 0 else 1]
                    common = _common_prefix(first, last)  # the keys are sorted
                    strip = 0 if len(level) == 1 else common
                    if height == 0:
                        body = leaf_body(group, strip)
                        n_keys = len(group)
                        tree, values = 0, sum(e[1] for e in group if e[2] is None)
                    else:
                        body = interior_body(group, height, strip)
                        n_keys, tree, values = (sum(c[i] for c in group) for i in (5, 6, 7))
                    off, ln = put(body)
                    children.append((first, last, common, off, ln, n_keys, tree + ln, values))
                if len(children) == 1:
                    root_ref = (height, *children[0][3:])
                    break
                height += 1
                sizes = [len(c[0]) + 64 for c in children]
                level = [children[a:b] for a, b in _groups(sizes, max_node_bytes, 2)]
        total = offset
    # the manifest: the database's uuid, a single-file manifest, the config
    # (orbax's limits, zstd at level 0), the data files, one version
    # (generation 1: its root's height, file, offset and length and the
    # tree's counts, its commit time) and no version-tree nodes
    body = [uuid.uuid4().bytes, _varint(0), _varint(MAX_INLINE_VALUE_BYTES), _varint(max_node_bytes),
            bytes([VERSION_TREE_ARITY_LOG2]), _varint(1), struct.pack("<i", 0)]
    height, off, ln, n_keys, tree, values = root_ref or (0, _NO_ROOT, _NO_ROOT, 0, 0, 0)  # empty: no root
    body += [_file_table_bytes([data_path]), _varint(1), _varint(1), bytes([height]),
             _varints([0, off, ln, n_keys, tree, values]), struct.pack("<Q", time.time_ns()), _varint(0)]
    manifest = _sealed(b"".join(body), MANIFEST_MAGIC)
    with open(os.path.join(root, "manifest.ocdbt"), "wb") as fp:
        fp.write(manifest)
    return total + len(manifest)


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


def zarr_items(name: str, array: np.ndarray, dtype: str | None = None) -> list:
    """The keys of ``array`` as orbax writes a zarr v2 array ``name``: its
    ``.zarray`` and one zstd level-1 chunk of its whole shape (C order).
    ``dtype``: the zarr dtype, where it is not numpy's (``"bfloat16"`` for
    an int16 or uint16 array of bfloat16 bits)."""
    if array.size == 0:
        raise ValueError(f"{name}: an array of zero size cannot be saved (orbax refuses it too)")
    array = np.require(array, requirements="C")
    shape = list(array.shape)
    meta = {"chunks": shape, "compressor": {"id": "zstd", "level": 1}, "dimension_separator": ".",
            "dtype": dtype or array.dtype.str, "fill_value": None, "filters": None, "order": "C",
            "shape": shape, "zarr_format": 2}
    chunk = ".".join("0" * len(shape)) or "0"
    return [(f"{name}/.zarray", json.dumps(meta, sort_keys=True, separators=(",", ":")).encode()),
            (f"{name}/{chunk}", zstd_compress(array, 1))]


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
    arrays = any(e["value_metadata"]["value_type"] not in _EMPTY for e in meta["tree_metadata"].values())
    store = read_ocdbt(path) if arrays else {}  # orbax writes no store for a tree without arrays
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


HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
_SCALARS = {bool: np.bool_, int: np.int64, float: np.float64}


def _flatten(tree, keys: list, out: list) -> None:
    """(keys, leaf) pairs in JAX's flattening order (dict keys sorted);
    keys are (name, key_type): 2 a dict key, 1 a sequence index. Empty
    containers and None are leaves, as orbax keeps them."""
    if isinstance(tree, dict) and tree:
        for k in sorted(tree):
            _flatten(tree[k], keys + [(str(k), 2)], out)
    elif isinstance(tree, (list, tuple)) and tree:
        for i, v in enumerate(tree):
            _flatten(v, keys + [(str(i), 1)], out)
    else:
        out.append((keys, tree))


def _value_type(leaf) -> str:
    if leaf is None:
        return "None"
    if isinstance(leaf, (list, tuple)):
        return "List"
    if isinstance(leaf, dict):
        return "Dict"
    if type(leaf) in _SCALARS:
        return "scalar"
    if isinstance(leaf, (torch.Tensor, np.ndarray, np.generic)):
        return "np.ndarray"
    raise TypeError(f"an orbax leaf cannot be a {type(leaf).__name__}")


def _host_array(leaf) -> tuple:
    """(numpy array, zarr dtype or None) of an array or scalar leaf: a
    tensor copied to the host, bfloat16 (which numpy lacks) by its bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), None
    if type(leaf) in _SCALARS:
        return np.asarray(leaf, _SCALARS[type(leaf)]), None
    array = np.asarray(leaf)
    return array, "bfloat16" if array.dtype.name == "bfloat16" else None


def save(path: str, tree) -> dict:
    """Write ``tree`` as ``ocp.StandardCheckpointer().save(path, tree,
    force=True)`` does, the inverse of ``restore``: dicts, lists and tuples
    (the JAX package's named tuples, such as optax's states, given as dicts
    keyed by field inside a list, as ``restore`` returns them and orbax
    keys them); leaves torch tensors on any device (bfloat16 by its bits),
    numpy arrays and scalars ("np.ndarray"), Python bools, ints and floats
    ("scalar": 0-d ``|b1``, ``<i8``, ``<f8``), and None, empty lists and
    empty dicts. Returns the bytes of the arrays and of the store written.

    The directory is written beside ``path`` (``<path>.orbax-checkpoint-
    tmp-<pid>``), its files and directories fsynced, then renamed over
    ``path``, replacing what was there: the old directory is first renamed
    to ``<path>.orbax-checkpoint-old-<pid>`` and removed once the new one
    is in place. A crash before the renames leaves the old checkpoint at
    ``path``; a crash between them leaves nothing at ``path`` and the old
    checkpoint under its ``-old-`` name, which no reader looks for (orbax's
    ``force=True`` has the same window: it deletes ``path`` first). A
    later save of ``path`` removes such leftovers."""
    path = os.path.abspath(path)
    init = time.time_ns()
    flat: list = []
    _flatten(tree, [], flat)
    tree_metadata, arrays = {}, []
    for keys, leaf in flat:
        vtype = _value_type(leaf)
        tree_metadata[str(tuple(k for k, _ in keys))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": {"value_type": vtype, "skip_deserialize": vtype in _EMPTY}}
        if vtype not in _EMPTY:
            arrays.append((".".join(k for k, _ in keys), leaf))
    stats = {"array_bytes": 0}

    def items():  # one leaf on the host at a time
        for name, leaf in arrays:
            array, dtype = _host_array(leaf)
            stats["array_bytes"] += array.nbytes
            yield from zarr_items(name, array, dtype)

    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp, old = (f"{path}.orbax-checkpoint-{kind}-{os.getpid()}" for kind in ("tmp", "old"))
    stale = [os.path.join(parent, n) for n in os.listdir(parent)
             if n.startswith(os.path.basename(path) + ".orbax-checkpoint-")]
    for leftover in stale:  # a killed save's: its tmp or its old directory
        if leftover.rsplit("-", 2)[-2] == "tmp" or os.path.lexists(path):
            shutil.rmtree(leftover, ignore_errors=True)
    os.makedirs(tmp)
    try:
        stats["store_bytes"] = write_ocdbt(tmp, items()) if arrays else 0
        with open(os.path.join(tmp, "_METADATA"), "w") as fp:
            json.dump({"tree_metadata": tree_metadata, "use_ocdbt": True, "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, fp)
        with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as fp:
            json.dump({"item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
                       "init_timestamp_nsecs": init, "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}, fp)
        for root, _, files in os.walk(tmp):
            for name in files:
                _fsync(os.path.join(root, name))
            _fsync(root)
        if os.path.lexists(path):
            os.rename(path, old)
        os.rename(tmp, path)
        _fsync(parent)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    for leftover in stale + [old]:
        if os.path.isdir(leftover) and not os.path.islink(leftover):
            shutil.rmtree(leftover, ignore_errors=True)
        elif os.path.lexists(leftover):
            os.remove(leftover)
    return stats


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
