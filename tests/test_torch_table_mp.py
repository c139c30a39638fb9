"""The table-parallel train step and the all-gather's backward of the
PyTorch port against the JAX package, on the CPU. The JAX side runs as
tests/test_table_mp.py runs it: the 8-device CPU mesh, the XLA collectives
(``use_pallas=False``). On the CPU the port's wrappers run their plain
versions; the CUDA kernels are held against those on the card by
chip_smoke.py.

Tolerances:
* the step: loss 1e-5 relative, every updated leaf 3e-5 absolute under
  SGD(0.5), the pins tests/test_table_mp.py:89,99 hold the JAX package's
  sharded step to;
* gradients through the all-gather: 1e-6 absolute, the pin of
  tests/test_ring.py:121;
* the reduce-scatter: bitwise against JAX for m <= 2 (at most one add); 1 ulp
  relative for more replicas, where XLA's all-reduce may add in another
  order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from avatarcraft_tpu.models.instant_nsr import init_field_params as jax_init_field_params
from avatarcraft_tpu.parallel.mesh import data_sharding, make_mesh, replicate
from avatarcraft_tpu.parallel.table_mp import make_table_mp_train_step as jax_make_step
from avatarcraft_tpu.parallel.table_mp import shard_grid_rows as jax_shard_grid_rows
from avatarcraft_tpu_torch.models import instant_nsr as nsr
from avatarcraft_tpu_torch.parallel import ring
from avatarcraft_tpu_torch.parallel.table_mp import TableMPTrainStep, shard_grid_rows
from avatarcraft_tpu_torch.utils.checkpoint import leaves
from avatarcraft_tpu_torch.utils.checkpoint import params_from_jax
from test_table_mp import FCFG, RCFG, _rays
from test_torch_render import _small_field


def _flat_with_paths(tree):
    return [(jax.tree_util.keystr(p), np.asarray(a)) for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_rcfg():
    return nsr.RenderConfig(num_steps=RCFG.num_steps, upsample_steps=RCFG.upsample_steps,
                            upsample_round=RCFG.upsample_round, perturb=False)


def test_table_mp_step_matches_jax_mesh():
    mesh = make_mesh(8)
    jparams = jax_init_field_params(jax.random.PRNGKey(0), FCFG)
    tx = optax.sgd(0.5)
    ro, rd, gt = _rays(32)
    key = jax.random.PRNGKey(7)

    params_rest, table, splice = jax_shard_grid_rows(jparams, mesh, leaf=-1)
    step = jax_make_step(mesh, FCFG, RCFG, tx, splice, w_eikonal=0.1, bg_value=1.0, use_pallas=False)
    params_rest = replicate(mesh, params_rest)
    opt_rest = replicate(mesh, tx.init(params_rest))
    opt_table = jax.tree_util.tree_map(lambda x: jax.device_put(x, table.sharding) if x.ndim else x, tx.init(table))
    sh2 = data_sharding(mesh, 2)
    params_rest, table, _, _, jloss = step(
        params_rest, table, opt_rest, opt_table,
        jax.device_put(ro, sh2), jax.device_put(rd, sh2), jax.device_put(gt, sh2), key,
    )
    want = _flat_with_paths(splice(params_rest, table.reshape(-1, table.shape[-1])))

    _, _, fcfg = _small_field()  # the port's FieldConfig of FCFG
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tstep = TableMPTrainStep(params, 8, fcfg, _port_rcfg(), lambda ps: torch.optim.SGD(ps, lr=0.5))
    assert len(tstep.shards) == 8 and all(s.shape == (64, 2) for s in tstep.shards)
    loss = tstep(*(torch.from_numpy(np.array(a)) for a in (ro, rd, gt)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = _flat_with_paths(jax.tree_util.tree_map(lambda t: t.numpy(), tstep.params()))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, b, atol=3e-5, rtol=0, err_msg=f"leaf {path} diverged")
    # the step owns clones: the caller's tree is untouched
    np.testing.assert_array_equal(params["grids"][-1].numpy(), np.asarray(jparams["grids"][-1]))


def test_table_mp_step_keeps_state_per_shard():
    _, params, fcfg = _small_field()
    opts = []

    def adam(ps):
        opts.append(torch.optim.Adam(ps, lr=1e-3))
        return opts[-1]

    tstep = TableMPTrainStep(params, 4, fcfg, _port_rcfg(), adam)
    ro, rd, gt = (torch.from_numpy(np.array(a)) for a in _rays(16))
    tstep(ro, rd, gt)
    rest_state, table_state = opts
    assert set(table_state.state) == {s for s in tstep.shards}
    assert all(table_state.state[s]["exp_avg"].shape == (128, 2) for s in tstep.shards)
    assert not any(p.shape == (512, 2) for p in rest_state.state)  # no full-table state
    assert len(rest_state.state) == len(leaves(tstep.rest))


@pytest.mark.parametrize("n", [1, 2, 8])
def test_all_gather_table_grad_matches_dense(n):
    """tests/test_ring.py:97-121's setup: the gradient of an embedding-lookup
    loss through the sharded table equals the dense gradient."""
    T, F = 64, 8
    table = np.array(jax.random.normal(jax.random.PRNGKey(0), (T, F)))
    idx = np.random.default_rng(1).integers(0, T, 32)
    tgt = np.array(jax.random.normal(jax.random.PRNGKey(2), (32, F)))
    want = np.asarray(jax.grad(lambda t: jnp.mean((t[idx] - tgt) ** 2))(jnp.asarray(table)))

    shards = [s.clone().requires_grad_() for s in torch.from_numpy(table).chunk(n)]
    full = ring.all_gather_table(shards)
    torch.mean((full[torch.from_numpy(idx)] - torch.from_numpy(tgt)) ** 2).backward()
    got = torch.cat([s.grad for s in shards]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert all(s.grad.shape == (T // n, F) for s in shards)


@pytest.mark.parametrize("encoder", ["tpu_pyramid", "hashgrid"])
def test_all_gather_table_under_no_grad_is_the_gather(rng, encoder):
    """The finest grid, or a hash-grid tree's table ([rows, C]), split into
    4 shards, gathered and spliced back into the same tree."""
    table = torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32))
    if encoder == "hashgrid":
        tree = {"table": table, "variance": table[0, 0]}
    else:
        tree = {"grids": [table.reshape(2, 2, 4, 4)]}
    rest, shards, splice = shard_grid_rows(tree, 4)
    with torch.no_grad():
        full = ring.all_gather_table(shards)
    assert not full.requires_grad and torch.equal(full, table)
    back = splice(rest, full)
    if encoder == "hashgrid":
        assert torch.equal(back["table"], table) and back["variance"] is tree["variance"]
    else:
        assert torch.equal(back["grids"][0], tree["grids"][0])


@pytest.mark.parametrize(
    "m,S,F",
    [pytest.param(m, 5, 3, id=str(m)) for m in (2, 4, 8)]
    # shards of S*F = 0, 1, 2 and 3 floats mod 4, F = 2 with an odd S (the
    # hash table's rows); m = 1 is the one card's trainer
    + [pytest.param(m, S, F, id=f"{m}-S{S}-F{F}")
       for m in (1, 2, 4) for S, F in ((4, 2), (5, 1), (7, 2), (3, 1))],
)
def test_reduce_scatter_rows_plain_matches_psum_scatter(rng, m, S, F):
    """m replicas on an m-device mesh: each holds its [m*S, F] cotangent;
    lax.psum_scatter(tiled=True) leaves replica i the sum of rows block i."""
    cts = rng.normal(size=(m, m * S, F)).astype(np.float32)
    mesh = make_mesh(m)
    sharded = jax.device_put(jnp.asarray(cts), NamedSharding(mesh, P("data")))
    want = np.asarray(jax.shard_map(
        lambda c: jax.lax.psum_scatter(c[0], "data", scatter_dimension=0, tiled=True),
        mesh=mesh, in_specs=P("data"), out_specs=P("data"),
    )(sharded))
    got = torch.cat(ring.reduce_scatter_rows([torch.from_numpy(c) for c in cts], m)).numpy()
    if m <= 2:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=1e-7)


def test_reduce_scatter_rows_plain_adds_in_replica_order():
    big, tiny = np.float32(1.0), np.float32(2.0**-24)
    cts = [torch.full((4, 1), float(v)) for v in (big, tiny, tiny)]
    before = dict(ring.launches)
    got = ring.reduce_scatter_rows(cts, 2)
    assert ring.launches == before  # the plain version is no launch
    # ((1 + 2^-24) + 2^-24) rounds to 1 at each add; any other order gives 1 + 2^-23
    assert all(torch.equal(g, torch.ones(2, 1)) for g in got)


@pytest.mark.parametrize(
    "cts,n,err",
    [
        ([], 1, "at least one"),
        ([torch.zeros(4, 2, dtype=torch.float16)], 2, "float32"),
        ([torch.zeros(4, 2, dtype=torch.float64)], 2, "float32"),
        ([torch.zeros(5, 2)], 2, "divisible"),
        ([torch.zeros(4, 2), torch.zeros(4, 3)], 2, "shapes"),
        ([torch.zeros(2, 4).T], 2, "contiguous"),
        ([torch.zeros(4, 2, device="meta")], 2, "cpu or cuda"),
    ],
)
def test_reduce_scatter_rows_rejects_bad_tables(cts, n, err):
    with pytest.raises(ValueError, match=err):
        ring.reduce_scatter_rows(cts, n)
