"""Table all-gather and its backward: reassemble a row-sharded table, and
return each shard its block of the table's gradient. Port of the JAX
package's parallel/ring.py:153-195 (``ring_all_gather_grad``,
``all_gather_table``), whose TPU kernel is the Pallas ICI ring
``_ring_all_gather_kernel`` (ring.py:27) with a psum_scatter VJP
(ring.py:168-169).

Two hand-written CUDA kernels, each behind a wrapper that takes its plain
version only for tensors on the CPU; a CUDA tensor launches the kernel or
raises:

* ``all_gather_rows`` (``csrc/all_gather_rows.cu``), the forward: a copy of
  the shards into one table (on one card all shards lie on it, so the ring's
  barrier and acks have nothing to order), with the shard pointers passed by
  value in the launch's parameters (at most ``MAX_SHARDS``), one wave of
  equal spans and TMA bulk copies. Plain version: ``torch.cat``.
* ``reduce_scatter_rows`` (``csrc/reduce_scatter_rows.cu``), the backward:
  the m replicas' cotangent tables summed in replica order and split into
  the n shard gradients, with the m + n pointers passed by value as the
  gather passes its own (at most ``MAX_TABLES``), the flat output cut into
  pieces whose load and store widths follow their alignment: at m = 1 (one
  card) the gather's staged TMA bulk copy where each shard's source and
  output agree mod 16, otherwise a block of in-order f32 sums a 4 KB
  chunk. Plain version: the same f32 adds in the same order, then the
  split.

Neither wrapper copies anything to the card, so a launch captured into a
CUDA graph holds all it reads (``workloads/reconstruct.py``'s graphed
train step).

``all_gather_table`` is the ``torch.autograd.Function`` over the two. On one
card there is one replica (m = 1).

Across the ranks of a mesh (``parallel.mesh``: one process per rank), the
table is row-sharded over processes and ``ring_all_gather`` /
``ring_all_gather_grad`` / ``all_gather_table(shard, mesh)`` gather it, the
port of ring.py:118-195 itself. Their kernel (``csrc/ring_peer.cu``) works
on peer memory: a symmetric buffer per (group, kind, size) that each rank
allocates, exports with a CUDA IPC handle and opens from every other rank,
with flags in the buffers for the TPU kernel's entry barrier and acks and
the rank's call count (the host passes no sequence number, so a CUDA graph
can hold and replay a call). A call is one launch and no host step:

* ``peer_all_gather``, the forward: each rank stages its shard in its
  buffer and copies the n buffers' shards into its table. Plain version:
  ``dist.all_gather``, then ``torch.cat``.
* ``peer_reduce_scatter``, the backward: each rank stages its [n*S, F]
  cotangent and sums block ``rank`` of the n buffers in rank order. Plain
  version: the n cotangents gathered (``dist.all_gather``), block ``rank``
  of each summed in rank order, which gloo's all_reduce would not keep.
* ``peer_all_reduce`` (``ring_all_reduce``), not a TPU kernel: the sum of
  a [N] f32 vector over the ranks in rank order, two-shot on buffers of
  the same design, for the mesh's loss psums and gradient all-reduce (where XLA
  inserts them in the JAX package). Its caller writes the input into the
  buffer (``all_reduce_input``): no staging. Plain version: the n inputs
  gathered, summed in rank order.

A wait that gives up sets a sticky error word, which ``check_peer_error``
reads after a step or a replay.
A mesh of one rank takes the one-card kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.distributed as dist

from avatarcraft_tpu_torch.utils.cuda_build import build, load_library

KERNEL = "all_gather_rows"
RS_KERNEL = "reduce_scatter_rows"
PEER_LIB = "ring_peer"  # csrc/ring_peer.cu: the cross-rank calls
PEER_GATHER = "peer_all_gather"
PEER_RS = "peer_reduce_scatter"
PEER_AR = "peer_all_reduce"  # csrc/ring_peer.cu too: the port's own, not a TPU kernel
AR_ALIGN = 4  # floats: an all-reduce block's rounding, so that each starts 16-byte aligned
# the kernels' by-value pointer tables (csrc/all_gather_rows.cu kMaxShards,
# csrc/reduce_scatter_rows.cu kMaxTables)
MAX_SHARDS = 128
MAX_TABLES = 128

# launches of each CUDA kernel in this process; only the launch functions
# add to them, and ``add_replayed`` for the launches a CUDA graph replays
launches = {KERNEL: 0, RS_KERNEL: 0, PEER_GATHER: 0, PEER_RS: 0, PEER_AR: 0}


def all_gather_rows_plain(shards) -> torch.Tensor:
    """[S, F] shards -> [n*S, F], in order."""
    return torch.cat(list(shards), dim=0)


def _check_tables(tables, what: str) -> None:
    if not tables:
        raise ValueError(f"{what} needs at least one table")
    first = tables[0]
    if first.dim() != 2:
        raise ValueError(f"{what} takes 2-D [S, F] tables, got shape {tuple(first.shape)}")
    for t in tables:
        if t.device != first.device:
            raise ValueError(f"tables on different devices: {t.device} and {first.device}")
        if t.dtype != first.dtype:
            raise ValueError(f"tables of different dtypes: {t.dtype} and {first.dtype}")
        if t.shape != first.shape:
            raise ValueError(f"tables of different shapes: {tuple(t.shape)} and {tuple(first.shape)}")
        if not t.is_contiguous():
            raise ValueError("tables must be contiguous")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, not {first.device}")


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    lib = load_library(name)
    if name == PEER_LIB:
        return _peer_library(lib)
    if name == KERNEL:
        lib.all_gather_rows.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ]
    else:
        lib.reduce_scatter_rows.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p,
        ]
    getattr(lib, name).restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def _checked(name: str, rc: int) -> None:
    if rc != 0:
        msg = getattr(_library(name), f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel failed: CUDA error {rc} ({msg})")
    launches[name] += 1


def add_replayed(counts: dict) -> None:
    """Count the launches of one replay of a CUDA graph: ``counts`` holds
    the launches its capture recorded, which the replay makes without
    passing through the launch functions."""
    for name, n in counts.items():
        launches[name] += n


def shard_pointers(shards):
    """The tensors' data pointers as the host array that a launch copies
    into the kernel's parameters."""
    return (ctypes.c_void_p * len(shards))(*(t.data_ptr() for t in shards))


def launch(ptrs, out: torch.Tensor, shard_bytes: int) -> None:
    """Launch all_gather_rows on the current stream: the shards of
    ``shard_bytes`` bytes whose pointers ``ptrs`` holds (``shard_pointers``)
    into ``out``. Counts the launch; raises if CUDA refuses it."""
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = _library(KERNEL).all_gather_rows(ptrs, len(ptrs), out.data_ptr(), shard_bytes, stream)
    _checked(KERNEL, rc)


def launch_reduce_scatter(ptrs, device, rows: int, cols: int, m: int, n: int) -> None:
    """Launch reduce_scatter_rows on the current stream of ``device``:
    ``ptrs`` (``shard_pointers``) holds the m cotangent tables' pointers,
    then the n outputs'. Counts the launch; raises if CUDA refuses it."""
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _library(RS_KERNEL).reduce_scatter_rows(ptrs, m, n, rows, cols, stream)
    _checked(RS_KERNEL, rc)


def all_gather_rows(shards) -> torch.Tensor:
    """Gather equal [S, F] shards, all on one device, into [n*S, F]; at
    most MAX_SHARDS of them."""
    shards = list(shards)
    _check_tables(shards, KERNEL)
    if len(shards) > MAX_SHARDS:
        raise ValueError(f"{KERNEL} takes at most MAX_SHARDS = {MAX_SHARDS} shards, got {len(shards)}")
    first = shards[0]
    if first.device.type == "cpu":
        return all_gather_rows_plain(shards)
    out = torch.empty((len(shards) * first.shape[0], first.shape[1]), dtype=first.dtype, device=first.device)
    if out.numel():
        launch(shard_pointers(shards), out, first.numel() * first.element_size())
    return out


def reduce_scatter_rows_plain(cts, n: int) -> list[torch.Tensor]:
    """Sum the [n*S, F] tables in order in f32 and split the sum into n
    [S, F] blocks."""
    total = cts[0].clone()
    for ct in cts[1:]:
        total += ct
    return list(total.chunk(n, dim=0))


def reduce_scatter_rows(cts, n: int) -> list[torch.Tensor]:
    """The all-gather's VJP: m cotangent tables [n*S, F] f32, one per
    replica, all on one device -> n shard gradients [S, F], shard i being
    the sum over replicas of rows [i*S, (i+1)*S)."""
    cts = list(cts)
    _check_tables(cts, RS_KERNEL)
    first = cts[0]
    if first.dtype != torch.float32:
        raise ValueError(f"reduce_scatter_rows adds in float32, got {first.dtype}")
    rows, cols = first.shape
    if n < 1 or rows % n:
        raise ValueError(f"table rows {rows} not divisible into {n} shards")
    if len(cts) + n > MAX_TABLES:
        raise ValueError(f"{RS_KERNEL} takes at most MAX_TABLES = {MAX_TABLES} tables and shards, got "
                         f"{len(cts)} + {n}")
    if first.device.type == "cpu":
        return reduce_scatter_rows_plain(cts, n)
    outs = [torch.empty((rows // n, cols), dtype=first.dtype, device=first.device) for _ in range(n)]
    launch_reduce_scatter(shard_pointers(cts + outs), first.device, rows // n, cols, len(cts), n)
    return outs


class _AllGatherTable(torch.autograd.Function):
    """Forward ``all_gather_rows``; backward ``reduce_scatter_rows`` of the
    one replica's cotangent (the JAX package's _ring_ag_bwd)."""

    @staticmethod
    def forward(ctx, *shards):
        ctx.n = len(shards)
        return all_gather_rows(shards)

    @staticmethod
    def backward(ctx, ct):
        return tuple(reduce_scatter_rows([ct.contiguous()], ctx.n))


def all_gather_table(shards, mesh=None) -> torch.Tensor:
    """Reassemble a row-sharded table into the full [T, F] table.
    Differentiable: each shard's gradient is its row block of the table's
    gradient. ``shards``: the list of shards from
    ``table_mp.shard_grid_rows``, all in this process; with a ``mesh`` of
    several ranks, this rank's one shard (a tensor or a one-element list),
    gathered across the ranks (``ring_all_gather_grad``: its gradient sums
    the ranks' cotangents)."""
    if mesh is not None and mesh.distributed:
        shard = shards if isinstance(shards, torch.Tensor) else _one(shards)
        return ring_all_gather_grad(shard, mesh)
    if isinstance(shards, torch.Tensor):
        shards = [shards]
    return _AllGatherTable.apply(*shards)


def _one(shards) -> torch.Tensor:
    shards = list(shards)
    if len(shards) != 1:
        raise ValueError(f"a rank of a mesh holds one shard of the table, got {len(shards)}")
    return shards[0]


# -- across the ranks of a mesh ------------------------------------------------


def build_kernels() -> None:
    """Build the cross-rank kernels' library (once, before ranks spawn)."""
    build([PEER_LIB])


def _peer_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    sigs = {
        "ring_peer_alloc": [i64, ctypes.POINTER(ptr)],
        "ring_peer_free": [ptr],
        "ring_peer_header_bytes": [],
        "ring_peer_handle_size": [],
        "ring_peer_handle": [ptr, ptr],
        "ring_peer_open": [ptr, ctypes.POINTER(ptr)],
        "ring_peer_close": [ptr],
        # (bases, n, me, share, ...): no sequence number, the count lives in the buffer
        "ring_peer_all_gather": [ctypes.POINTER(ptr), i32, i32, i32, ptr, ptr, i64, ptr],
        "ring_peer_reduce_scatter": [ctypes.POINTER(ptr), i32, i32, i32, ptr, ptr, i64, ptr],
        "ring_peer_all_reduce": [ctypes.POINTER(ptr), i32, i32, i32, ptr, i64, i64, ptr],
        "ring_peer_error": [],
    }
    for fn, args in sigs.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = i32
    lib.ring_peer_clear_error.argtypes = []
    lib.ring_peer_clear_error.restype = None
    lib.ring_peer_error_string.argtypes = [i32]
    lib.ring_peer_error_string.restype = ctypes.c_char_p
    _peer_loaded.append(lib)
    return lib


_peer_loaded: list = []  # the cross-rank library, once this process has loaded it


def _peer_checked(what: str, rc: int) -> None:
    if rc != 0:
        msg = _library(PEER_LIB).ring_peer_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: error {rc} ({msg})")


def check_peer_error() -> None:
    """Raise if a wait of a cross-rank call of this process gave up (a peer
    stopped calling, or the ranks' calls differ): the kernels' sticky error
    word, read in host memory without a synchronisation, so it shows the
    calls that have ended. Read after a step (``mesh.all_reduce_grads``), a
    scan's replays and a kernel check; the host alone clears it."""
    if _peer_loaded:
        rc = _peer_loaded[0].ring_peer_error()
        if rc:
            raise RuntimeError(f"a cross-rank call failed: error {rc} "
                               f"({_peer_loaded[0].ring_peer_error_string(rc).decode()})")


class _CudaArray:
    """``numel`` f32 elements at a device address, for ``torch.as_tensor``
    (the CUDA array interface; no stream is named, so nothing
    synchronises)."""

    def __init__(self, ptr: int, numel: int):
        self.__cuda_array_interface__ = {"shape": (numel,), "typestr": "<f4", "data": (ptr, False), "version": 2}


class PeerBuffer:
    """A rank's symmetric buffer of one (group, kind, size): ``own`` (its
    address), the n ranks' buffers as mapped in this process (``bases``,
    the kernel's by-value table), the rank's place ``me`` among them and
    ``share``, the ranks of the group on this card, whose kernels wait on
    each other there (the kernel sizes its grid so that all of theirs fit).
    The buffer's header on the card holds the rank's call count: the host
    passes no sequence number."""

    def __init__(self, own: int, bases, me: int, share: int, nbytes: int, device, opened=()):
        self.own, self.me, self.share, self.nbytes = own, me, share, nbytes
        self.n, self.device, self.opened = len(bases), torch.device(device), list(opened)
        self.bases = (ctypes.c_void_p * self.n)(*bases)
        self._views: dict = {}

    def view(self, numel: int) -> torch.Tensor:
        """The first ``numel`` f32 elements of the buffer's data as a tensor
        that aliases it: what a caller writes there, the next all-reduce
        reads without a stage. Made once per length (never while a graph is
        captured: the warm-up step makes it)."""
        if numel not in self._views:
            if numel * 4 > self.nbytes:
                raise ValueError(f"a view of {numel} floats exceeds the buffer's {self.nbytes} bytes")
            data = self.own + _library(PEER_LIB).ring_peer_header_bytes()
            self._views[numel] = torch.as_tensor(_CudaArray(data, numel), device=self.device)
        return self._views[numel]


def _alloc(nbytes: int) -> int:
    own = ctypes.c_void_p()
    _peer_checked("ring_peer_alloc", _library(PEER_LIB).ring_peer_alloc(nbytes, ctypes.byref(own)))
    return own.value


def ranks_on_card(mesh) -> int:
    """The ranks of ``mesh`` that share this rank's card (``rank_device``
    puts rank r on card r % count)."""
    count = max(torch.cuda.device_count(), 1)
    return len(range(mesh.rank % count, mesh.size, count))


def _exchange(mesh, nbytes: int) -> PeerBuffer:
    """This rank's buffer, made and exported, and its peers' opened (a
    collective: every rank makes the same calls)."""
    lib = _library(PEER_LIB)
    own = _alloc(nbytes)
    handle = ctypes.create_string_buffer(lib.ring_peer_handle_size())
    _peer_checked("ring_peer_handle", lib.ring_peer_handle(own, handle))
    handles = [None] * mesh.size
    dist.all_gather_object(handles, handle.raw, group=mesh.group)
    opened, bases = [], []
    for p, h in enumerate(handles):
        if p == mesh.rank:
            bases.append(own)
            continue
        peer = ctypes.c_void_p()
        _peer_checked("ring_peer_open", lib.ring_peer_open(ctypes.create_string_buffer(h, len(h)),
                                                           ctypes.byref(peer)))
        opened.append(peer.value)
        bases.append(peer.value)
    return PeerBuffer(own, bases, mesh.rank, ranks_on_card(mesh), nbytes, mesh.device, opened)


def local_peer_group(n: int, nbytes: int, device="cuda") -> list[PeerBuffer]:
    """n ranks as n streams of this process on one card: a buffer each,
    every rank's ``bases`` the same n addresses. Rank r's calls go on its
    own stream; all n ranks must make the same calls. Free with
    ``free_local_group``."""
    owns = [_alloc(nbytes) for _ in range(n)]
    return [PeerBuffer(own, owns, r, n, nbytes, device) for r, own in enumerate(owns)]


def free_local_group(bufs) -> None:
    torch.cuda.synchronize(bufs[0].device)
    check_peer_error()
    for buf in bufs:
        _peer_checked("ring_peer_free", _library(PEER_LIB).ring_peer_free(buf.own))


# (id of the group, kind, bytes, card) -> PeerBuffer
_peer_buffers: dict = {}


def peer_buffer(mesh, kind: str, nbytes: int) -> PeerBuffer:
    """The rank's buffer for calls of ``kind`` moving ``nbytes`` per rank,
    made on first use (a collective: every rank makes the same calls). A
    CUDA graph holds the buffers' addresses, so every buffer a captured
    step uses must exist before the capture (its eager warm-up step makes
    them): making one during a capture raises."""
    key = (id(mesh.group), kind, nbytes, mesh.device.index)
    buf = _peer_buffers.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"a {kind} call of {nbytes} bytes a rank inside a CUDA graph's capture, with no "
                               "buffer made for it: its buffer is made by a collective, so run the step once "
                               "eagerly before the capture")
        buf = _peer_buffers[key] = _exchange(mesh, nbytes)
    return buf


def release_peer_buffers(mesh) -> None:
    """Unmap and free this rank's buffers once every rank is done with
    them (a collective, at the end of a rank); raise if a call failed."""
    if not _peer_buffers:
        return
    lib = _library(PEER_LIB)
    torch.cuda.synchronize(mesh.device)
    check_peer_error()
    dist.barrier(group=mesh.group)  # no rank still reads a peer's buffer
    for buf in _peer_buffers.values():
        for ptr in buf.opened:
            _peer_checked("ring_peer_close", lib.ring_peer_close(ptr))
    dist.barrier(group=mesh.group)  # every mapping of a buffer is gone before it is freed
    for buf in _peer_buffers.values():
        _peer_checked("ring_peer_free", lib.ring_peer_free(buf.own))
    _peer_buffers.clear()


def _launch_peer(name: str, buf: PeerBuffer, out: torch.Tensor, count: int, src: torch.Tensor | None = None) -> None:
    """One call of ``name`` on ``buf``: one launch of the peer kernel on the
    current stream and no host step (the kernel reads its sequence number
    from the buffer). ``count``: the gather's shard bytes, the
    reduce-scatter's block floats, the all-reduce's output floats. Counts
    the launch; raises if CUDA refuses it."""
    lib = _library(PEER_LIB)
    head = (buf.bases, buf.n, buf.me, buf.share)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    if name == PEER_GATHER:
        rc = lib.ring_peer_all_gather(*head, src.data_ptr(), out.data_ptr(), count, stream)
    elif name == PEER_RS:
        rc = lib.ring_peer_reduce_scatter(*head, src.data_ptr(), out.data_ptr(), count, stream)
    else:
        rc = lib.ring_peer_all_reduce(*head, out.data_ptr(), buf.nbytes // (4 * (buf.n + 1)), count, stream)
    _peer_checked(name, rc)
    launches[name] += 1


def ring_all_gather_plain(shard: torch.Tensor, mesh) -> torch.Tensor:
    """[S, F] on each rank -> [n*S, F] in rank order (``dist.all_gather``)."""
    parts = [torch.empty_like(shard) for _ in range(mesh.size)]
    dist.all_gather(parts, shard, group=mesh.group)
    return torch.cat(parts)


def _rank_order_sum(parts) -> torch.Tensor:
    total = parts[0].clone()
    for part in parts[1:]:
        total += part
    return total


def ring_reduce_scatter_plain(ct: torch.Tensor, mesh) -> torch.Tensor:
    """[n*S, F] on each rank -> this rank's block of their sum, added in
    rank order in f32."""
    parts = [torch.empty_like(ct) for _ in range(mesh.size)]
    dist.all_gather(parts, ct, group=mesh.group)
    return _rank_order_sum([p.chunk(mesh.size)[mesh.rank] for p in parts])


def ring_all_reduce_plain(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``x`` gathered (``dist.all_gather``) and added in rank
    order: the sum, the same bits on every rank."""
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return _rank_order_sum(parts)


def _check_mesh_table(t: torch.Tensor, what: str, mesh) -> None:
    _check_tables([t], what)
    if t.device.type == "cuda" and t.device != mesh.device:
        raise ValueError(f"{what}: a tensor on {t.device}, but this rank runs on {mesh.device}")


def ring_all_gather(shard: torch.Tensor, mesh) -> torch.Tensor:
    """Gather every rank's [S, F] shard into [n*S, F] on every rank (the
    JAX package's ring_all_gather). One rank: the one-card kernel."""
    if not mesh.distributed:
        return all_gather_rows([shard])
    _check_mesh_table(shard, PEER_GATHER, mesh)
    if shard.device.type == "cpu":
        return ring_all_gather_plain(shard, mesh)
    out = torch.empty((mesh.size * shard.shape[0], shard.shape[1]), dtype=shard.dtype, device=shard.device)
    nbytes = shard.numel() * shard.element_size()
    _launch_peer(PEER_GATHER, peer_buffer(mesh, PEER_GATHER, staged_bytes(nbytes)), out, nbytes, shard)
    return out


def ring_reduce_scatter(ct: torch.Tensor, mesh) -> torch.Tensor:
    """The gather's VJP (the JAX package's psum_scatter): every rank's
    [n*S, F] f32 cotangent -> this rank's [S, F] block of their sum, added
    in rank order. One rank: the one-card kernel."""
    if not mesh.distributed:
        return reduce_scatter_rows([ct], 1)[0]
    _check_mesh_table(ct, PEER_RS, mesh)
    if ct.dtype != torch.float32:
        raise ValueError(f"{PEER_RS} adds in float32, got {ct.dtype}")
    rows, cols = ct.shape
    if rows % mesh.size:
        raise ValueError(f"table rows {rows} not divisible into {mesh.size} shards")
    if ct.device.type == "cpu":
        return ring_reduce_scatter_plain(ct, mesh)
    out = torch.empty((rows // mesh.size, cols), dtype=ct.dtype, device=ct.device)
    _launch_peer(PEER_RS, peer_buffer(mesh, PEER_RS, staged_bytes(ct.numel() * 4)), out, out.numel(), ct)
    return out


def staged_bytes(nbytes: int) -> int:
    """A gather's or reduce-scatter's buffer for ``nbytes`` of input a rank:
    two slots, which the calls use in turn (``csrc/ring_peer.cu``)."""
    return 2 * nbytes


def all_reduce_bytes(numel: int, n: int) -> int:
    """An all-reduce buffer's data bytes for ``numel`` floats over n ranks:
    the input's n blocks of ceil(numel / n) floats, each rounded up to
    AR_ALIGN (so every block starts 16-byte aligned), then one block for
    this rank's block of the sum; the padding is zeros at first and never
    reaches an output."""
    block = -(-max(numel, 1) // n)
    return (n + 1) * (-(-block // AR_ALIGN) * AR_ALIGN) * 4


def all_reduce_input(numel: int, mesh) -> torch.Tensor:
    """Where a caller writes the [numel] f32 input of ``ring_all_reduce``:
    on a CUDA mesh this rank's symmetric buffer itself, so that the call
    stages nothing (its next call overwrites it); on the CPU a new
    tensor."""
    if mesh.device.type == "cuda" and mesh.distributed:
        return peer_buffer(mesh, PEER_AR, all_reduce_bytes(numel, mesh.size)).view(numel)
    return torch.empty(numel, dtype=torch.float32, device=mesh.device)


def ring_all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the ranks of every rank's ``x``, added in rank order
    (p = 0, 1, ..., n-1) in f32: the same bits on every rank, and the same
    order on the card as on the CPU. On the card one launch of the peer
    kernel, two-shot on the symmetric buffers (block ``rank`` of the sum
    written into this rank's buffer, then the n summed blocks gathered); an
    ``x`` that is ``all_reduce_input``'s tensor is read in place, any other
    is first copied there. Not a TPU kernel: it stands where XLA inserts a
    psum. One rank: ``x`` itself."""
    if not mesh.distributed:
        return x
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{PEER_AR} runs on cpu or cuda tensors, not {x.device}")
    if x.device.type == "cuda" and x.device != mesh.device:
        raise ValueError(f"{PEER_AR}: a tensor on {x.device}, but this rank runs on {mesh.device}")
    if x.device.type == "cpu":
        return ring_all_reduce_plain(x, mesh)
    if x.dtype != torch.float32:
        raise ValueError(f"{PEER_AR} adds in float32, got {x.dtype}")
    numel = x.numel()
    buf = peer_buffer(mesh, PEER_AR, all_reduce_bytes(numel, mesh.size))
    inp = buf.view(numel)
    if inp.data_ptr() != x.data_ptr():
        inp.copy_(x.reshape(-1))
    out = torch.empty(numel, dtype=torch.float32, device=x.device)
    _launch_peer(PEER_AR, buf, out, numel)
    return out.view(x.shape)


class _RingAllGather(torch.autograd.Function):
    """Forward ``ring_all_gather``; backward ``ring_reduce_scatter`` (the
    JAX package's ring_all_gather_grad with its psum_scatter VJP)."""

    @staticmethod
    def forward(ctx, shard, mesh):
        ctx.mesh = mesh
        return ring_all_gather(shard, mesh)

    @staticmethod
    def backward(ctx, ct):
        return ring_reduce_scatter(ct.contiguous(), ctx.mesh), None


def ring_all_gather_grad(shard: torch.Tensor, mesh) -> torch.Tensor:
    """Differentiable ``ring_all_gather``: each rank's shard gradient is its
    block of the table's gradient summed over the ranks."""
    return _RingAllGather.apply(shard, mesh)
