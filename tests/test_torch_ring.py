"""The table all-gather and the grid-row split of the PyTorch port against
the JAX package, on the CPU. On the CPU the wrapper runs its plain version
(torch.cat); the CUDA kernel is held against that plain version on the card
by chip_smoke.py. Tolerance: none, a gather copies values."""

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
