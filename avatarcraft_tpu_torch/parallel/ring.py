"""Table all-gather: reassemble a row-sharded table, forward only. Port of
the JAX package's parallel/ring.py:175 ``all_gather_table``, whose TPU
kernel is the Pallas ICI ring ``_ring_all_gather_kernel`` (ring.py:27).

``all_gather_rows`` wraps the hand-written CUDA kernel
``csrc/all_gather_rows.cu`` (a direct gather: on one card all shards lie on
it, so the ring's barrier and acks have nothing to order). Its plain version
``all_gather_rows_plain`` is ``torch.cat``; the wrapper takes it only for
tensors on the CPU. A CUDA tensor launches the kernel or raises.

The backward (the JAX package's psum_scatter) and the ring over NVLink
across cards come with the training slice (ROADMAP queue 2, K10).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from avatarcraft_tpu_torch.utils.cuda_build import load_library

KERNEL = "all_gather_rows"

# launches of the CUDA kernel in this process; only launch() adds to it
launches = 0


def all_gather_rows_plain(shards) -> torch.Tensor:
    """[S, F] shards -> [n*S, F], in order."""
    return torch.cat(list(shards), dim=0)


def _check_shards(shards) -> None:
    if not shards:
        raise ValueError("all_gather_rows needs at least one shard")
    first = shards[0]
    if first.dim() != 2:
        raise ValueError(f"shards must be [S, F] tables, got shape {tuple(first.shape)}")
    for s in shards:
        if s.device != first.device:
            raise ValueError(f"shards on different devices: {s.device} and {first.device}")
        if s.dtype != first.dtype:
            raise ValueError(f"shards of different dtypes: {s.dtype} and {first.dtype}")
        if s.shape != first.shape:
            raise ValueError(f"shards of different shapes: {tuple(s.shape)} and {tuple(first.shape)}")
        if not s.is_contiguous():
            raise ValueError("shards must be contiguous")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library(KERNEL)
    lib.all_gather_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.all_gather_rows.restype = ctypes.c_int
    lib.all_gather_rows_error_string.argtypes = [ctypes.c_int]
    lib.all_gather_rows_error_string.restype = ctypes.c_char_p
    return lib


def shard_pointer_array(shards) -> torch.Tensor:
    """The device array of the shards' data pointers that the kernel reads,
    copied from pinned memory without blocking the host (the caching host
    allocator keeps the pinned block until the copy on this stream ran)."""
    ptrs = torch.tensor([s.data_ptr() for s in shards], dtype=torch.int64).pin_memory()
    return ptrs.to(shards[0].device, non_blocking=True)


def launch(ptrs: torch.Tensor, out: torch.Tensor, rows: int, row_bytes: int, n: int) -> None:
    """Launch the kernel on the current stream: n shards of ``rows`` rows of
    ``row_bytes`` bytes, their pointers in ``ptrs``, into ``out``. The one
    place that counts a launch; raises if CUDA refuses it."""
    global launches
    lib = _library()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = lib.all_gather_rows(ptrs.data_ptr(), out.data_ptr(), rows, row_bytes, n, stream)
    if rc != 0:
        msg = lib.all_gather_rows_error_string(rc).decode()
        raise RuntimeError(f"all_gather_rows kernel failed: CUDA error {rc} ({msg})")
    launches += 1


def all_gather_rows(shards) -> torch.Tensor:
    """Gather equal [S, F] shards, all on one device, into [n*S, F]."""
    shards = list(shards)
    _check_shards(shards)
    first = shards[0]
    if first.device.type == "cpu":
        return all_gather_rows_plain(shards)
    if first.device.type != "cuda":
        raise ValueError(f"all_gather_rows runs on cpu or cuda tensors, not {first.device}")
    rows, cols = first.shape
    out = torch.empty((len(shards) * rows, cols), dtype=first.dtype, device=first.device)
    launch(shard_pointer_array(shards), out, rows, cols * first.element_size(), len(shards))
    return out


def all_gather_table(shards) -> torch.Tensor:
    """Reassemble a row-sharded table (the list of shards from
    ``table_mp.shard_grid_rows``) into the full [T, F] table."""
    return all_gather_rows(shards)
