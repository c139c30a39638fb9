"""The table all-gather and the grid-row split of the PyTorch port against
the JAX package, on the CPU. On the CPU the wrapper runs its plain version
(torch.cat); the CUDA kernel is held against that plain version on the card
by chip_smoke.py. Tolerance: none, a gather copies values."""

import ctypes
import inspect
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from avatarcraft_tpu.parallel.mesh import make_mesh
from avatarcraft_tpu.parallel.ring import all_gather_table as jax_all_gather_table
from avatarcraft_tpu_torch.parallel import ring
from avatarcraft_tpu_torch.parallel.table_mp import shard_grid_rows
from avatarcraft_tpu_torch.utils import cuda_build


@pytest.mark.parametrize("rows,cols,dtype", [(8 * 16, 4, np.float32), (8 * 5, 3, np.float16)])
def test_all_gather_table_matches_jax_mesh(rng, rows, cols, dtype):
    table = rng.normal(size=(rows, cols)).astype(dtype)
    mesh = make_mesh(8)
    sharded = jax.device_put(jnp.asarray(table), NamedSharding(mesh, P("data", None)))
    want = np.asarray(jax_all_gather_table(sharded, mesh))
    shards = list(torch.from_numpy(table).chunk(8))
    got = ring.all_gather_table(shards)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), table)


def test_cpu_path_is_plain_and_not_counted(rng):
    shards = [torch.from_numpy(rng.normal(size=(6, 4)).astype(np.float32)) for _ in range(3)]
    before = dict(ring.launches)
    got = ring.all_gather_rows(shards)
    assert ring.launches == before  # only a kernel launch counts
    assert torch.equal(got, ring.all_gather_rows_plain(shards))


@pytest.mark.parametrize(
    "shards,err",
    [
        ([], "at least one"),
        ([torch.zeros(8)], r"\[S, F\]"),
        ([torch.zeros(4, 2), torch.zeros(4, 2, dtype=torch.float16)], "dtypes"),
        ([torch.zeros(4, 2), torch.zeros(5, 2)], "shapes"),
        ([torch.zeros(2, 4).T, torch.zeros(2, 4).T], "contiguous"),
        ([torch.zeros(4, 2), torch.zeros(4, 2, device="meta")], "devices"),
        ([torch.zeros(4, 2, device="meta")], "cpu or cuda"),
    ],
)
def test_wrapper_rejects_bad_shards(shards, err):
    with pytest.raises(ValueError, match=err):
        ring.all_gather_rows(shards)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_shard_grid_rows_round_trip(rng, n):
    R, C = 8, 3
    grids = [torch.from_numpy(rng.normal(size=(r, r, r, C)).astype(np.float32)) for r in (4, R)]
    params = {"grids": grids, "planes": [torch.ones(3, 5, 5, 2)], "variance": torch.tensor(0.3)}
    rest, shards, splice = shard_grid_rows(params, n)
    assert len(shards) == n and all(s.shape == (R**3 // n, C) for s in shards)
    assert rest["grids"][-1] is None  # the leaf lives in the shards
    assert shards[0].data_ptr() == grids[-1].data_ptr()  # views, not copies
    assert rest["grids"][0] is grids[0] and rest["planes"] is params["planes"]
    back = splice(rest, ring.all_gather_table(shards))
    assert torch.equal(back["grids"][-1], grids[-1])
    assert torch.equal(back["grids"][0], grids[0])
    assert back["variance"] is params["variance"]


def test_shard_grid_rows_rejects_uneven_split():
    with pytest.raises(ValueError, match="divisible"):
        shard_grid_rows({"grids": [torch.zeros(3, 3, 3, 2)]}, 2)


def test_default_shard_count_cpu():
    # one shard per card in use: the port drives one card
    params = {"grids": [torch.zeros(4, 4, 4, 2)]}
    assert len(shard_grid_rows(params)[1]) == 1


@pytest.mark.parametrize("n", [ring.MAX_SHARDS, ring.MAX_SHARDS + 1])
def test_shard_cap_is_checked_on_cpu_too(n):
    """The kernel takes at most MAX_SHARDS pointers by value; the wrapper
    refuses more before it picks a path, so the CPU takes what the card takes."""
    shards = [torch.full((2, 3), float(i)) for i in range(n)]
    if n <= ring.MAX_SHARDS:
        assert torch.equal(ring.all_gather_rows(shards), torch.cat(shards))
    else:
        with pytest.raises(ValueError, match=f"MAX_SHARDS = {ring.MAX_SHARDS}"):
            ring.all_gather_rows(shards)


def _source(name: str) -> str:
    with open(cuda_build.source_path(name)) as fp:
        return fp.read()


def test_shard_cap_matches_the_kernel():
    assert re.search(rf"constexpr int kMaxShards = {ring.MAX_SHARDS};", _source(ring.KERNEL))


@pytest.mark.parametrize("wrapper", [ring.all_gather_rows, ring.reduce_scatter_rows])
def test_only_reduce_scatter_copies_pointers_to_the_card(wrapper):
    """By inspection: both wrappers pass their pointers by value in the
    launch's parameters (no pinned buffer, no host-to-device copy); the
    reduce-scatter's device array of pointers is gone, so neither copies
    anything to the card and a CUDA graph can hold either launch."""
    src = inspect.getsource(wrapper)
    assert "shard_pointers(" in src
    assert not hasattr(ring, "pointer_array") and "pin_memory" not in inspect.getsource(ring)


def test_table_cap_matches_the_kernel():
    assert re.search(rf"constexpr int kMaxTables = {ring.MAX_TABLES};", _source(ring.RS_KERNEL))


def test_table_cap_is_checked_on_cpu_too():
    """m + n pointers fill the reduce-scatter's by-value table; one more is
    refused on every device, as the gather refuses a 129th shard."""
    cts = [torch.zeros((ring.MAX_TABLES - 2) * (ring.MAX_TABLES - 1), 1) for _ in range(2)]
    assert len(ring.reduce_scatter_rows(cts, ring.MAX_TABLES - 2)) == ring.MAX_TABLES - 2
    with pytest.raises(ValueError, match=f"MAX_TABLES = {ring.MAX_TABLES}"):
        ring.reduce_scatter_rows(cts, ring.MAX_TABLES - 1)


def test_every_reduce_scatter_kernel_is_named_for_the_profilers():
    """profile_train.py and chip_smoke.py find the backward's device
    kernels by the substring ``reduce_scatter_rows_kernel`` and the
    gather's by ``gather_rows_kernel``: each kernel of the backward's
    source carries the one and not the other."""
    names = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(", _source(ring.RS_KERNEL))
    assert names and all("reduce_scatter_rows_kernel" in n and "gather_rows_kernel" not in n for n in names)


def _c_params(name: str) -> list[str]:
    """The parameter types of ``int name(...)`` in the kernel's source."""
    sig = re.search(rf"^int {name}\(([^)]*)\)", _source(name), re.M)
    assert sig, f"no extern C signature of {name}"
    return [re.sub(r"\s*\w+$", "", p.strip()) for p in sig.group(1).split(",")]


def _kind_of_c(ctype: str) -> str:
    if "*" in ctype or ctype == "cudaStream_t":
        return "pointer"
    return {"int": "int32", "long long": "int64"}[ctype]


def _kind_of_ctypes(t) -> str:
    if t is ctypes.c_void_p or issubclass(t, ctypes._Pointer):
        return "pointer"
    return {ctypes.c_int: "int32", ctypes.c_longlong: "int64"}[t]


@pytest.mark.parametrize("name", [ring.KERNEL, ring.RS_KERNEL])
def test_ctypes_argtypes_match_the_c_signature(monkeypatch, name):
    """``ring._library`` declares, for each kernel's launch function, the
    argument kinds of its ``extern "C"`` signature (pointer, 32- or 64-bit
    integer) in order: a mismatch would cut a pointer or shift the
    arguments. The library itself is replaced by a stand-in (nvcc builds it
    on the card only)."""
    fake = types.SimpleNamespace(**{name: types.SimpleNamespace(), f"{name}_error_string": types.SimpleNamespace()})
    monkeypatch.setattr(ring, "load_library", lambda _: fake)
    lib = ring._library.__wrapped__(name)
    declared = [_kind_of_ctypes(t) for t in getattr(lib, name).argtypes]
    assert declared == [_kind_of_c(p) for p in _c_params(name)]
    assert getattr(lib, name).restype is ctypes.c_int


def _event(device, name, us=0.0, kernels=(), children=()):
    return types.SimpleNamespace(
        device_type=device, name=name, cpu_children=list(children),
        kernels=[types.SimpleNamespace(name=k, duration=d) for k, d in kernels],
        time_range=types.SimpleNamespace(elapsed_us=lambda: us),
    )


@pytest.mark.parametrize("ties", [0, 1, 2])
def test_profilers_count_a_ctypes_kernel_once(ties):
    """The profilers leave the gather kernel out of the time the profiler
    attributes to a range and add its own device events, each once: the
    profiler ties a kernel launched through ctypes to the ops around it
    once, twice (the first launch in a profile) or not at all."""
    from torch.autograd import DeviceType

    from avatarcraft_tpu_torch.utils.timing import device_us_without, kernel_device_us

    full = "(anonymous namespace)::gather_rows_kernel(ShardTable, Plan)"
    tied = [(full, 23.0)]
    op = _event(DeviceType.CPU, "_AllGatherTable", kernels=tied * min(ties, 1) + [("memcpy", 1.0)],
                children=[_event(DeviceType.CPU, "aten::empty", kernels=tied * max(ties - 1, 0))])
    rng = _event(DeviceType.CPU, "render.gather", children=[op])
    events = [
        rng, op, _event(DeviceType.CUDA, full, 23.0),
        _event(DeviceType.CUDA, "render.gather", 23.0),  # the range's device-side copy
        _event(DeviceType.CUDA, "reduce_scatter_rows_kernel", 5.0),
    ]
    assert device_us_without(rng, ("gather_rows_kernel",)) == 1.0
    assert device_us_without(rng, ("gather_rows_kernel",)) + kernel_device_us(events, "gather_rows_kernel") == 24.0
