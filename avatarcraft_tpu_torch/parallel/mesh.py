"""A mesh of ranks over torch.distributed: port of the JAX package's
parallel/mesh.py (make_mesh, data_sharding, shard_batch, replicate at
:23-50).

JAX drives n devices from one process, and GSPMD keeps every reduction
global. Here a rank is a process, one per mesh position, in a
``torch.distributed`` process group on the gloo backend: rank r runs on
``cuda:(r % torch.cuda.device_count())``, or on the CPU when the caller asks
for it. Ranks share a card when there are more ranks than cards (NCCL
refuses two ranks on one card; gloo carries the collectives of CUDA tensors
through the host), and ``make_mesh`` says so once. The mesh is never cut to
fit the devices: JAX's ``make_mesh`` takes ``devices[:n]``, this one raises
when n is not the group's size.

Where JAX uses an XLA collective in a step, the port's own calls stand
(``parallel.ring``, never gloo on the card): ``psum`` for the batch's
global sums and ``all_reduce_grads`` for the gradients of replicated
parameters, both ``ring.ring_all_reduce`` (the same rank order on the card
and the CPU, so every rank gets the same bits, and a CUDA graph can hold
them), and the gather of a row-sharded table with its reduce-scatter
backward. gloo's library collectives remain for what runs on the host or
once a frame: ``replicate``, ``all_gather_rows_of`` and ``max_over_ranks``.

``launch(fn, n, *args)`` spawns the n ranks (start method ``spawn``: no
process forks after CUDA is up), builds the cross-rank kernels first in the
parent, runs ``fn(mesh, *args)`` in each and returns the ranks' results in
rank order; a rank's exception stops every rank and is raised in the parent.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from avatarcraft_tpu_torch.parallel import ring
from avatarcraft_tpu_torch.utils.checkpoint import map_leaves

AXIS = "data"
DEFAULT_TIMEOUT_S = 900.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a 1-D mesh of ``size`` ranks: its ``rank``,
    its ``device`` and the process ``group`` (None for one rank)."""

    size: int
    rank: int
    device: torch.device
    group: object = None
    axis_name: str = AXIS

    @property
    def distributed(self) -> bool:
        return self.size > 1


def one_rank(device="cpu") -> Mesh:
    """This process alone: the mesh of one rank on ``device``, over which
    every collective here is the identity. The callers that take
    ``mesh=None`` mean this mesh; only ``shard_batch`` and ``replicate``
    read its device."""
    return Mesh(1, 0, torch.device(device))


def rank_device(rank: int, device: str) -> torch.device:
    """Rank r's device: ``cuda:(r % count)`` for "cuda", else the CPU."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA card: pass device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", rank % count)


def sharing_note(n: int, device: torch.device) -> str:
    """'2 ranks on 1 card (NVIDIA H100 80GB HBM3)' or '4 ranks on the CPU'."""
    if device.type != "cuda":
        return f"{n} ranks on the CPU"
    cards = min(n, torch.cuda.device_count())
    names = sorted({torch.cuda.get_device_name(i) for i in range(cards)})
    return f"{n} ranks on {cards} card{'s' if cards > 1 else ''} ({', '.join(names)})"


def make_mesh(n_devices: int | None = None, device: str = "cuda") -> Mesh:
    """The mesh of the current process group (called inside a rank), or of
    this process alone when no group is up. ``n_devices`` must be the
    group's size: a mesh is never cut to fit. Rank r takes
    ``rank_device(r, device)`` and makes it current; rank 0 prints how the
    ranks sit on the cards."""
    if dist.is_available() and dist.is_initialized():
        size, rank, group = dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    else:
        size, rank, group = 1, 0, None
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} ranks asked for in a group of {size}: launch {n_devices} ranks "
                         "(parallel.mesh.launch); a mesh is never cut to fit")
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if rank == 0 and size > 1:
        print(f"[mesh] {sharing_note(size, dev)}", flush=True)
    return Mesh(size, rank, dev, group if size > 1 else None)


def data_sharding(mesh: Mesh, rows: int) -> slice:
    """The rows of a [rows, ...] batch that rank r holds, [r rows/n, (r+1)
    rows/n), as ``P("data", None...)`` places them. Refuses rows % n."""
    if rows % mesh.size:
        raise ValueError(f"a batch of {rows} rows does not split into {mesh.size} equal shards")
    per = rows // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def _to_device(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of every [B, ...] leaf of ``tree`` (numpy arrays or
    tensors), on ``mesh.device``."""
    return map_leaves(tree, lambda x: _to_device(x[data_sharding(mesh, len(x))], mesh.device))


def shard_draw(mesh: Mesh, rows: int, cols: int, generator: torch.Generator | None, device) -> torch.Tensor:
    """This rank's ``rows`` rows of one U(0, 1) [rows * n, cols] draw from
    ``generator`` (the same generator state on every rank): the jitter of a
    global batch, cut as its rays are, so that n ranks see the draw one
    rank would."""
    full = torch.rand((rows * mesh.size, cols), generator=generator, device=device)
    return full[data_sharding(mesh, rows * mesh.size)]


def replicate(mesh: Mesh, tree):
    """Every tensor leaf of ``tree`` on ``mesh.device``, broadcast from rank
    0, so that the replicas start bitwise equal. The leaves are copies."""

    def one(x):
        t = _to_device(x, mesh.device).clone()
        if mesh.distributed:
            dist.broadcast(t, src=0, group=mesh.group)
        return t

    return map_leaves(tree, one)


class _PSum(torch.autograd.Function):
    """Forward: the sum over ranks (``ring.ring_all_reduce``). Backward: the
    cotangent as it is. Every rank goes on to compute the same global loss
    from the sum and back-propagates it, so each rank's own term gets the
    loss's cotangent once; the gradients of replicated parameters are then
    summed once, by ``all_reduce_grads``."""

    @staticmethod
    def forward(ctx, x, mesh):
        return ring.ring_all_reduce(x.detach(), mesh)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks (differentiable), added in rank
    order; ``x`` itself on one rank."""
    return _PSum.apply(x, mesh) if mesh.distributed else x


def global_mean(local_sum: torch.Tensor, local_count: int, mesh: Mesh) -> torch.Tensor:
    """A mean over the global batch from each rank's sum over its equal
    share of ``local_count`` values."""
    return psum(local_sum, mesh) / (local_count * mesh.size)


def global_ratio(num: torch.Tensor, den: torch.Tensor, mesh: Mesh, eps: float = 1e-5) -> torch.Tensor:
    """(sum num) / (sum den + eps) over the ranks: the eikonal term's
    weighted mean over the whole batch (the JAX package's
    models/instant_nsr.py gradient_error), which a mean of per-rank means
    cannot reproduce."""
    return psum(num, mesh) / (psum(den, mesh) + eps)


def all_reduce_grads(params, mesh: Mesh) -> None:
    """Sum the ``.grad`` of each replicated parameter over the ranks, in
    place, in one ``ring.ring_all_reduce`` of their concatenation (a
    missing grad counts as zeros), written straight into the all-reduce's
    buffer on the card. Every rank gets the same bits, so the same
    optimizer step keeps the replicas equal. The gradients are float32, as
    every trainer's are (its bf16 tables are made from f32 parameters each
    step); another dtype is refused. First reads the cross-rank calls'
    error word (``ring.check_peer_error``): once a step."""
    if not mesh.distributed:
        return
    ring.check_peer_error()
    params = [p for p in params]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    for g in grads:
        if g.dtype != torch.float32:
            raise ValueError(f"all_reduce_grads sums float32 gradients, got {g.dtype}")
    flat = ring.all_reduce_input(sum(g.numel() for g in grads), mesh)
    torch.cat([g.reshape(-1) for g in grads], out=flat)
    flat = ring.ring_all_reduce(flat, mesh)
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[offset : offset + n].view_as(g).clone()
        offset += n


def all_gather_rows_of(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' equal [m, ...] row blocks, concatenated in rank order on
    every rank: gloo's all_gather through the host, which the final gather
    of a frame (once a frame) and the checks can afford."""
    if not mesh.distributed:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts)


def max_over_ranks(value: int, mesh: Mesh) -> int:
    """The largest of the ranks' integers (a budget every rank can take):
    a host value, through gloo's all_reduce."""
    if not mesh.distributed:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return int(t.item())


# -- launching the ranks -------------------------------------------------------


def free_port() -> int:
    """A free TCP port on localhost for the group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _host(tree):
    """Tensors in a rank's result as numpy arrays (they cross the queue by
    pickle)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    return tree


def _rank_main(rank: int, n: int, port: int, device: str, work, results, timeout_s: float) -> None:
    if torch.device(device).type != "cuda":
        torch.set_num_threads(1)
    status = 0
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=n,
                                timeout=datetime.timedelta(seconds=timeout_s))
        mesh = make_mesh(n, device)
        fn, args = work.get()
        value = _host(fn(mesh, *args))
        if mesh.device.type == "cuda":
            ring.release_peer_buffers(mesh)
        results.put((rank, True, value))
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - every failure goes to the parent, which raises it
        # reported at once: the peers may wait in a collective this rank
        # will not join (its buffers go with the process)
        results.put((rank, False, traceback.format_exc()))
        status = 1
    os._exit(status)  # skip interpreter teardown: a failed peer may hold the group


def launch(fn, n: int, *args, device: str = "cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(mesh, *args)`` in n ranks and return their results in rank
    order (tensors as numpy arrays). ``fn`` and ``args`` must pickle (a
    module-level function). On the card the cross-rank kernels are built
    here first, so that the n ranks do not run nvcc at once. A rank that
    raises stops every rank, and its traceback is raised here; so is a rank
    that dies or a run past ``timeout_s``."""
    if n < 1:
        raise ValueError(f"a mesh needs at least one rank, got {n}")
    if torch.device(device).type == "cuda":
        ring.build_kernels()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.SimpleQueue()
    # (fn, args) reach the ranks through a queue, not the process arguments:
    # spawn writes those into a pipe that a child reads only after importing
    # the main module, so large arguments would start the ranks one by one
    work = ctx.Queue()
    work.cancel_join_thread()  # a rank that dies unread must not hold the parent at exit
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, n, port, device, work, results, timeout_s), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    for _ in procs:  # every rank takes one copy
        work.put((fn, args))
    got, failure = {}, None
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < n and failure is None:
            if not results.empty():
                rank, ok, value = results.get()
                if ok:
                    got[rank] = value
                else:
                    failure = f"rank {rank} of {n} failed:\n{value}"
                continue
            dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in got]
            if dead and results.empty():
                failure = f"rank {dead[0]} of {n} exited with code {procs[dead[0]].exitcode} and no result"
            elif time.monotonic() > deadline:
                failure = f"the {n} ranks did not finish within {timeout_s:.0f} s"
            else:
                time.sleep(0.01)
    finally:
        for p in procs:
            p.join(timeout=30 if failure is None else 1)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        results.close()
        work.close()
    if failure is not None:
        raise RuntimeError(failure)
    return [got[r] for r in range(n)]
