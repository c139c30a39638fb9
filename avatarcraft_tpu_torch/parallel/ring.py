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
  gather passes its own (at most ``MAX_TABLES``). Plain version: the same
  f32 adds in the same order, then the split.

Neither wrapper copies anything to the card, so a launch captured into a
CUDA graph holds all it reads (``workloads/reconstruct.py``'s graphed
train step).

``all_gather_table`` is the ``torch.autograd.Function`` over the two. On one
card there is one replica (m = 1). The ring over NVLink across cards is
still to port (ROADMAP, K10).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from avatarcraft_tpu_torch.utils.cuda_build import load_library

KERNEL = "all_gather_rows"
RS_KERNEL = "reduce_scatter_rows"
# the kernels' by-value pointer tables (csrc/all_gather_rows.cu kMaxShards,
# csrc/reduce_scatter_rows.cu kMaxTables)
MAX_SHARDS = 128
MAX_TABLES = 128

# launches of each CUDA kernel in this process; only the launch functions
# add to them, and ``add_replayed`` for the launches a CUDA graph replays
launches = {KERNEL: 0, RS_KERNEL: 0}


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


def all_gather_table(shards) -> torch.Tensor:
    """Reassemble a row-sharded table (the list of shards from
    ``table_mp.shard_grid_rows``) into the full [T, F] table. Differentiable:
    each shard's gradient is its row block of the table's gradient."""
    return _AllGatherTable.apply(*shards)
