"""A model of ``csrc/ring_peer.cu``'s protocol, to run on the host under
chosen interleavings: the cross-rank gather, reduce-scatter and all-reduce
on symmetric buffers with flags, a device call count and a grid-wide count.

The kernel's header comment states the protocol; this module repeats it
step for step. Each rank owns one buffer per kind of call: its header,
and ``n`` blocks of ``ELEMS`` elements in each of the gather's and the
reduce-scatter's two slots, or in the all-reduce's input and one more for
its block of the sum. A call is one kernel of G blocks, and
each block is a generator that yields before every step that touches
shared state (a flag, a count, an element), or yields a predicate that
must hold before it goes on (a wait). ``run`` interleaves the blocks of
every rank in the order a ``numpy`` generator draws, and holds:

* no rank reads an element before the peer that owns it has written it
  for this call (the input staged, or the all-reduce's sum written back);
* no rank overwrites an element before every reader of its previous
  contents has read it (the acks);
* no schedule deadlocks: some block can always go on until every rank has
  made every call.

A rank's calls run in order, as kernels on one stream; the all-reduce's
caller writes its input into the buffer before the kernel. ``slots``
bounds the blocks resident on the card at once (the kernel sizes its
persistent grid so that every rank's blocks fit); ``host_seq`` makes the
kernel take its sequence number from the host, as before the redesign,
where a replayed graph passes the number of its capture.
"""

from __future__ import annotations

import dataclasses

import numpy as np

OPS = ("gather", "reduce_scatter", "all_reduce")
ELEMS = 2  # elements of a region (a rank's block of the data)


class ProtocolError(AssertionError):
    """A read of data not yet written, or an overwrite of unread data."""


class Deadlock(AssertionError):
    """No block can go on, and some rank has calls left."""


@dataclasses.dataclass
class Header:
    n: int
    calls: int = 0
    arrived: int = 0
    ready: list = None
    reduced: list = None
    done: list = None

    def __post_init__(self):
        self.ready, self.reduced, self.done = [0] * self.n, [0] * self.n, [0] * self.n


class Buffers:
    """The n ranks' buffers of one kind: headers, and each element's label
    (("in", k) or ("sum", k): written for logical call k) with the count of
    its reads. An element is (rank, region, block, index): the gather's
    and the reduce-scatter's regions are the two slots 0 and 1, the
    all-reduce's its input (0) and its sum block ("sum", block 0)."""

    def __init__(self, kind: str, n: int):
        self.kind, self.n = kind, n
        self.headers = [Header(n) for _ in range(n)]
        self.label, self.reads = {}, {}

    def expected_reads(self, label) -> int:
        """How many reads a label's contents get: the gather's input by
        every rank, the reduce-scatter's and all-reduce's input block q by
        rank q, the all-reduce's sum block by every rank."""
        if self.kind == "gather" or label[0] == "sum":
            return self.n
        return 1

    def write(self, key: tuple, label) -> None:
        old = self.label.get(key)
        if old is not None and self.reads.get((key, old), 0) != self.expected_reads(old):
            raise ProtocolError(f"{self.kind}: element {key} overwritten with {label} after "
                                f"{self.reads.get((key, old), 0)} of {self.expected_reads(old)} reads of {old}")
        self.label[key] = label

    def read(self, key: tuple, label) -> None:
        if self.label.get(key) != label:
            raise ProtocolError(f"{self.kind}: element {key} read for {label}, holds {self.label.get(key)}")
        self.reads[(key, label)] = self.reads.get((key, label), 0) + 1


def _mine(b: int, G: int, elems: list) -> list:
    """The elements that block b of G handles (a grid-stride loop)."""
    return [x for i, x in enumerate(elems) if i % G == b]


def block(bufs: Buffers, me: int, b: int, G: int, k: int, host_seq: int | None):
    """Block b of G of rank me's kernel for logical call k (1, 2, ...):
    the kernel's steps. ``host_seq``: the sequence number the host passes
    (the old design), or None (the device's call count)."""
    n, kind, h = bufs.n, bufs.kind, bufs.headers[me]
    seq = h.calls + 1 if host_seq is None else host_seq  # 0. the call count
    yield
    region = seq % 2 if kind != "all_reduce" else 0  # the input's slot
    every = [(q, e) for q in range(n) for e in range(ELEMS)]
    if kind != "all_reduce":  # 1. stage, once every peer has read the slot's contents of call seq - 2
        yield lambda: all(h.done[p] >= seq - 2 for p in range(n))
        for q, e in _mine(b, G, every):
            bufs.write((me, region, q, e), ("in", k))
            yield
    target = G

    def arrive():  # the grid-wide count: True in the last block
        nonlocal target
        h.arrived += 1
        last = h.arrived == target
        target += G
        return last

    if arrive():  # 2. entry barrier
        yield
        for p in range(n):
            bufs.headers[p].ready[me] = seq
            yield
    yield lambda: all(h.ready[p] >= seq for p in range(n))
    if kind == "gather":  # 3. body
        for p in range(n):
            for q, e in _mine(b, G, every):
                bufs.read((p, region, q, e), ("in", k))
                yield
    else:
        for e in _mine(b, G, list(range(ELEMS))):
            for p in range(n):
                bufs.read((p, region, me, e), ("in", k))
                yield
            if kind == "all_reduce":  # the sum's block into this rank's sum block
                bufs.write((me, "sum", 0, e), ("sum", k))
                yield
        if kind == "all_reduce":
            if arrive():
                yield
                for p in range(n):
                    bufs.headers[p].reduced[me] = seq
                    yield
            yield lambda: all(h.reduced[p] >= seq for p in range(n))
            for p in range(n):
                for e in _mine(b, G, list(range(ELEMS))):
                    bufs.read((p, "sum", 0, e), ("sum", k))
                    yield
    if arrive():  # 4. exit
        yield
        for p in range(n):
            bufs.headers[p].done[me] = seq
            yield
        h.arrived = 0
        h.calls = seq
        yield


def caller_write(bufs: Buffers, me: int, k: int):
    """The all-reduce's caller writes its input into its own buffer (a
    kernel of the stream before the call's)."""
    for q in range(bufs.n):
        for e in range(ELEMS):
            bufs.write((me, 0, q, e), ("in", k))
            yield


def schedule(rng: np.random.Generator, n_calls: int) -> list:
    """A list of calls that every rank makes: (kind, host sequence number
    of the old design). Eager calls, and graphs of 1 to 3 calls captured
    once (an eager warm-up first; the capture runs nothing but counts on
    the host) and replayed 1 to 3 times."""
    host = {kind: 0 for kind in OPS}
    calls = []
    while len(calls) < n_calls:
        if rng.random() < 0.4:
            kind = OPS[rng.integers(len(OPS))]
            host[kind] += 1
            calls.append((kind, host[kind]))
            continue
        graph = [OPS[i] for i in rng.integers(len(OPS), size=rng.integers(1, 4))]
        for kind in graph:  # the warm-up, eager
            host[kind] += 1
            calls.append((kind, host[kind]))
        captured = []
        for kind in graph:  # the capture: the host counts, the card runs nothing
            host[kind] += 1
            captured.append((kind, host[kind]))
        for _ in range(rng.integers(1, 4)):
            calls.extend(captured)
    return calls


def run(n: int, calls: list, rng: np.random.Generator, grids=None, slots: int | None = None,
        host_seq: bool = False) -> int:
    """Every rank makes ``calls`` (``schedule``), each call's kernel of
    ``grids[rank]`` blocks (default 1 to 3, drawn per rank and call), the
    blocks interleaved in ``rng``'s order with at most ``slots`` resident
    at once. Raises ProtocolError or Deadlock; returns the steps taken."""
    bufs = {kind: Buffers(kind, n) for kind in OPS}
    logical = [{kind: 0 for kind in OPS} for _ in range(n)]
    streams = []
    for me in range(n):
        ops = []
        for kind, seq in calls:
            logical[me][kind] += 1
            k = logical[me][kind]
            G = int(grids[me]) if grids is not None else int(rng.integers(1, 4))
            if kind == "all_reduce":
                ops.append([caller_write(bufs[kind], me, k)])
            ops.append([block(bufs[kind], me, b, G, k, seq if host_seq else None) for b in range(G)])
        streams.append(ops)
    heads = [0] * n  # each rank's current op
    running, waiting, pending = {}, {}, []  # block id -> generator / predicate; blocks without a slot
    steps = 0

    def start(me: int) -> None:
        if heads[me] < len(streams[me]):
            pending.extend((me, heads[me], i, g) for i, g in enumerate(streams[me][heads[me]]))

    for me in range(n):
        start(me)
    while pending or running:
        resident = len(running)
        free = None if slots is None else slots - resident
        while pending and (free is None or free > 0):  # the card starts blocks in launch order per rank
            j = int(rng.integers(len(pending)))
            me, op, i, g = pending[j]
            if any(p[0] == me and p[1] == op and p[2] < i for p in pending):
                j = next(x for x, p in enumerate(pending) if p[0] == me and p[1] == op)
                me, op, i, g = pending[j]
            pending.pop(j)
            running[(me, op, i)] = g
            waiting[(me, op, i)] = None
            if free is not None:
                free -= 1
        ready = [key for key, pred in waiting.items() if pred is None or pred()]
        if not ready:
            raise Deadlock(f"no block can go on after {steps} steps ({len(running)} resident, "
                           f"{len(pending)} without a slot)")
        key = ready[int(rng.integers(len(ready)))]
        try:
            waiting[key] = next(running[key])
        except StopIteration:
            del running[key], waiting[key]
            me, op, _ = key
            if not any(k[0] == me and k[1] == op for k in running) and not any(
                    p[0] == me and p[1] == op for p in pending):
                heads[me] += 1  # the stream's next op starts after this one
                start(me)
        steps += 1
    for kind, b in bufs.items():  # every rank's count advanced once a call
        want = sum(1 for c, _ in calls if c == kind)
        if not host_seq and any(h.calls != want for h in b.headers):
            raise ProtocolError(f"{kind}: call counts {[h.calls for h in b.headers]}, {want} calls made")
    return steps
