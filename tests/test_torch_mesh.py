"""The mesh of ranks (parallel/mesh.py), the cross-rank table gather and its
VJP (parallel/ring.py), table parallelism and the trainers over a mesh, and
the canonical CLI's --mesh_devices, on the CPU against the JAX package.

The port's ranks are processes (gloo, one torch thread each), spawned once
per fixture: 4 ranks for the mesh and the ring, 2 ranks for the trainers.
The JAX side runs on 4 (or 2) of the conftest's 8 CPU devices. On the CPU the
cross-rank wrappers take their plain versions (gloo's all_gather, then the
port's sums in rank order, so that psum and the gradient all-reduce add as
the card's kernel does); the CUDA kernels are held against those on the
card by chip_smoke.py.

Tolerances:
* the shardings, the replicas and the gather: exact;
* the gather's VJP against JAX's psum_scatter: 1e-6 relative on random
  cotangents (the port adds the ranks' blocks in rank order, XLA's
  all-reduce in an order of its own), bitwise on small integers, which f32
  adds exactly in any order;
* the all-reduce against JAX's psum: bitwise at 2 ranks (one add, the same
  in either order), 1e-6 relative at 4 on inputs in [0, 1) (no
  cancellation, so another order moves a sum by a few ulp); bitwise
  against the rank-order sum, and psum, all_reduce_grads and the plain
  reduce-scatter then gather bitwise equal on every rank;
* table parallelism: loss 1e-5 relative, leaves 3e-5 under SGD(0.5), the
  pins tests/test_table_mp.py holds JAX's sharded step to;
* the trainers over 2 ranks against one process: losses 1e-5 relative and
  parameters 1e-5 absolute over 2 Adam steps (lr 5e-4: a sign flip of a
  near-zero gradient would move a parameter by 1e-3), measured below 1e-6.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from avatarcraft_tpu.parallel.mesh import data_sharding as jax_data_sharding
from avatarcraft_tpu.parallel.mesh import make_mesh as jax_make_mesh
from avatarcraft_tpu.parallel.mesh import replicate as jax_replicate
from avatarcraft_tpu.parallel.ring import ring_all_gather, ring_all_gather_grad
from avatarcraft_tpu.parallel.table_mp import make_table_mp_train_step as jax_make_step
from avatarcraft_tpu.parallel.table_mp import shard_grid_rows as jax_shard_grid_rows
from avatarcraft_tpu.models.instant_nsr import init_field_params as jax_init_field_params
from avatarcraft_tpu_torch import bench
from avatarcraft_tpu_torch.cli import render_canonical_cli as cli
from avatarcraft_tpu_torch.models import instant_nsr as nsr
from avatarcraft_tpu_torch.parallel import mesh as mesh_lib
from avatarcraft_tpu_torch.utils.checkpoint import params_from_jax
from avatarcraft_tpu_torch.workloads import reconstruct as recon
from test_table_mp import FCFG, RCFG, _rays
from test_torch_reconstruct_cli import TINY_HASH, TINY_PYR, _one_torch_thread  # noqa: F401
from test_torch_render import _small_field
import torch_mesh_ranks

N4, S, F = 4, 8, 128
TRAIN_STEPS = 2


def _port_rcfg():
    return nsr.RenderConfig(num_steps=RCFG.num_steps, upsample_steps=RCFG.upsample_steps,
                            upsample_round=RCFG.upsample_round, perturb=False)


def _flat(tree):
    return [(jax.tree_util.keystr(p), np.asarray(a)) for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return {
        "batch": {"x": rng.normal(size=(16, 3)).astype(np.float32), "i": np.arange(16, dtype=np.int32)},
        "table": (np.arange(N4 * S * F, dtype=np.float32).reshape(N4 * S, F) / 100.0),
        "cts": rng.normal(size=(N4, N4 * S, F)).astype(np.float32),
        "int_cts": rng.integers(-50, 50, size=(N4, N4 * S, F)).astype(np.float32),
        "sums": rng.random((N4, 24 * 5)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def table_mp_jax():
    jparams = jax_init_field_params(jax.random.PRNGKey(0), FCFG)
    return jax.tree_util.tree_map(np.asarray, jparams)


@pytest.fixture(scope="module")
def four_ranks(inputs, table_mp_jax):
    _, _, fcfg = _small_field()
    return mesh_lib.launch(torch_mesh_ranks.four_ranks, N4, inputs["batch"], inputs["table"], inputs["cts"],
                           inputs["int_cts"], params_from_jax(table_mp_jax, "cpu"), fcfg, _port_rcfg(),
                           tuple(np.asarray(a) for a in _rays(32)), inputs["sums"], device="cpu", timeout_s=300)


def _disc_set(n_views=2, res=8):
    """A tiny in-memory image set: random images of a few views."""
    rng = np.random.default_rng(3)
    K = np.array([[10.0, 0, res / 2], [0, 10.0, res / 2], [0, 0, 1]], np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * n_views)
    poses[:, 2, 3] = 2.0 + 0.1 * np.arange(n_views)
    return recon.ImageSet(K=K, poses=poses, images=rng.random((n_views, res, res, 3)).astype(np.float32),
                          masks=np.ones((n_views, res, res), np.float32))


TRAIN_CFG = recon.ReconstructConfig(batch_size=16, epochs=1)
FCFGS = {
    "hash": TINY_HASH,
    "rcfg": nsr.RenderConfig(num_steps=6, upsample_steps=6, upsample_round=6, perturb=True),
    "pyr": dataclasses.replace(TINY_PYR, packed_dtype="float32"),
    "fast": nsr.FastRenderConfig(n_probes=16, k_samples=6, bound=1.6),
    # 1407 table rows: odd, so no mesh of an even rank count could row-shard it
    "hash_odd": nsr.FieldConfig(encoder="hashgrid", grid=nsr.HashGridSpec(
        num_levels=3, log2_hashmap_size=10, base_resolution=3, desired_resolution=9)),
}


@pytest.fixture(scope="module")
def two_ranks(table_mp_jax, inputs):
    _, _, fcfg = _small_field()
    return mesh_lib.launch(torch_mesh_ranks.two_ranks, 2, params_from_jax(table_mp_jax, "cpu"), fcfg, _port_rcfg(),
                           tuple(np.asarray(a) for a in _rays(32)), _disc_set(), FCFGS, TRAIN_CFG, TRAIN_STEPS,
                           inputs["sums"][:2], device="cpu", timeout_s=300)


def test_mesh_ranks_and_devices(four_ranks):
    assert [r["rank"] for r in four_ranks] == list(range(N4))
    assert all(r["size"] == N4 and r["device"] == "cpu" and r["axis"] == "data" for r in four_ranks)
    assert mesh_lib.rank_device(5, "cpu") == torch.device("cpu")
    assert mesh_lib.sharing_note(4, torch.device("cpu")) == "4 ranks on the CPU"
    for r in four_ranks:  # psum of r + 1 over the ranks
        assert float(r["psum"][0]) == sum(range(1, N4 + 1))


def test_make_mesh_never_cuts_the_mesh():
    """One process and no group: a mesh of one rank; asking for 4 raises
    (the JAX package's make_mesh would take devices[:4])."""
    mesh = mesh_lib.make_mesh(None, "cpu")
    assert (mesh.size, mesh.rank, mesh.group, mesh.distributed) == (1, 0, None, False)
    with pytest.raises(ValueError, match="never cut"):
        mesh_lib.make_mesh(4, "cpu")


def test_shard_batch_and_replicate_match_jax_shardings(four_ranks, inputs):
    mesh = jax_make_mesh(N4)
    for key, x in inputs["batch"].items():
        placed = jax.device_put(jnp.asarray(x), jax_data_sharding(mesh, np.ndim(x)))
        by_device = {s.device: np.asarray(x[s.index]) for s in placed.addressable_shards}
        for r, dev in enumerate(mesh.devices.flatten()):
            np.testing.assert_array_equal(four_ranks[r]["sharded"][key], by_device[dev])
        replicated = jax_replicate(mesh, jnp.asarray(x))
        for r in range(N4):  # every rank holds rank 0's values, as every device holds the array
            np.testing.assert_array_equal(four_ranks[r]["replicated"][key], np.asarray(replicated))
    rows = [r["rows"] for r in four_ranks]
    assert rows == [(r * S, (r + 1) * S) for r in range(N4)]
    assert all("does not split" in r["uneven"] for r in four_ranks)


def test_ring_all_gather_matches_jax_interpret(four_ranks, inputs):
    """Bitwise JAX's Pallas ring in interpret mode on 4 devices."""
    from jax.experimental.pallas import tpu as pltpu

    mesh = jax_make_mesh(N4)
    want = jax.shard_map(
        lambda s: ring_all_gather(s, "data", interpret=pltpu.InterpretParams()),
        mesh=mesh, in_specs=P("data", None), out_specs=P(), check_vma=False,
    )(jnp.asarray(inputs["table"]))
    for r in four_ranks:
        np.testing.assert_array_equal(r["gathered"], np.asarray(want))


@pytest.mark.parametrize("key", ["vjp", "vjp_int"])
def test_gather_vjp_matches_psum_scatter(four_ranks, inputs, key):
    """Each rank's shard gradient: its block of the ranks' cotangents summed
    (JAX: the VJP of ring_all_gather_grad, a psum_scatter)."""
    mesh = jax_make_mesh(N4)
    cts = inputs["cts" if key == "vjp" else "int_cts"]

    def vjp(shard, ct):
        _, pull = jax.vjp(lambda s: ring_all_gather_grad(s, "data", False), shard)
        return pull(ct[0])[0]

    want = np.asarray(jax.shard_map(vjp, mesh=mesh, in_specs=(P("data", None), P("data")),
                                    out_specs=P("data", None), check_vma=False)(
        jnp.asarray(inputs["table"]), jnp.asarray(cts)))
    for r in range(N4):
        got, block = four_ranks[r][key], want[r * S : (r + 1) * S]
        assert got.shape == (S, F)
        if key == "vjp_int":
            np.testing.assert_array_equal(got, block)
        else:
            np.testing.assert_allclose(got, block, rtol=1e-6, atol=0)
        # the port's order: rank 0's block first, then 1, 2, 3
        order = cts[0][r * S : (r + 1) * S].copy()
        for p in range(1, N4):
            order += cts[p][r * S : (r + 1) * S]
        np.testing.assert_array_equal(got, order)


@pytest.mark.parametrize("n", [2, 4])
def test_all_reduce_matches_jax_psum(four_ranks, two_ranks, inputs, n):
    """ring_all_reduce_plain over n gloo ranks against lax.psum under
    shard_map on n CPU devices, and bitwise the sum in rank order."""
    ranks = four_ranks if n == N4 else two_ranks
    sums = inputs["sums"][:n]
    want = np.asarray(jax.shard_map(lambda x: jax.lax.psum(x, "data"), mesh=jax_make_mesh(n), in_specs=P("data"),
                                    out_specs=P(), check_vma=False)(jnp.asarray(sums)))[0]
    order = sums[0].copy()
    for p in range(1, n):
        order += sums[p]
    for r in ranks:
        got = r["sums"]["all_reduce"]
        np.testing.assert_array_equal(got.view(np.int32), order.view(np.int32))
        if n == 2:
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_psum_and_grads_give_every_rank_the_same_bits(four_ranks, two_ranks, n):
    """psum and all_reduce_grads on a CPU mesh: every rank the same bits,
    those of the plain reduce-scatter followed by the plain gather."""
    ranks = four_ranks if n == N4 else two_ranks
    first = ranks[0]["sums"]["rs_gather"].view(np.int32)
    for r in ranks:
        for key in ("all_reduce", "psum", "grads", "rs_gather"):
            np.testing.assert_array_equal(r["sums"][key].view(np.int32), first, err_msg=key)


def _jax_table_mp(n, jparams):
    mesh = jax_make_mesh(n)
    tx = optax.sgd(0.5)
    ro, rd, gt = _rays(32)
    params_rest, table, splice = jax_shard_grid_rows(jax.tree_util.tree_map(jnp.asarray, jparams), mesh, leaf=-1)
    step = jax_make_step(mesh, FCFG, RCFG, tx, splice, w_eikonal=0.1, bg_value=1.0, use_pallas=False)
    params_rest = jax_replicate(mesh, params_rest)
    opt_table = jax.tree_util.tree_map(lambda x: jax.device_put(x, table.sharding) if x.ndim else x, tx.init(table))
    sh2 = jax_data_sharding(mesh, 2)
    params_rest, table, _, _, loss = step(params_rest, table, jax_replicate(mesh, tx.init(params_rest)), opt_table,
                                          jax.device_put(ro, sh2), jax.device_put(rd, sh2), jax.device_put(gt, sh2),
                                          jax.random.PRNGKey(7))
    return float(loss), _flat(splice(params_rest, table.reshape(-1, table.shape[-1])))


def _hold_table_mp(port: dict, n: int, jparams) -> None:
    jloss, want = _jax_table_mp(n, jparams)
    np.testing.assert_allclose(port["loss"], jloss, rtol=1e-5)
    got = _flat(port["params"])
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, b, atol=3e-5, rtol=0, err_msg=f"leaf {path} diverged")
    assert port["n_shards"] == 1 and port["shard_rows"] == 512 // n  # each rank holds its own shard alone


def test_table_mp_over_two_ranks_matches_jax(two_ranks, table_mp_jax):
    for r in two_ranks:
        _hold_table_mp(r["table_mp"], 2, table_mp_jax)


def test_table_mp_over_four_ranks_matches_jax(four_ranks, table_mp_jax):
    for r in four_ranks:
        _hold_table_mp(r["table_mp"], N4, table_mp_jax)


def test_trainers_over_two_ranks_match_one_process(two_ranks, _one_torch_thread):  # noqa: F811
    """train (jitter on: each rank its rows of the global draw), train_fast,
    train_fast's scan and train_fast on a hash grid over 2 ranks against
    one process; the replicas equal on both ranks."""
    want = torch_mesh_ranks.trainer_losses(_disc_set(), FCFGS, TRAIN_CFG, TRAIN_STEPS)
    for name, (losses, params) in want.items():
        for rank in two_ranks:
            got_losses, got_params = rank["trainers"][name]
            np.testing.assert_allclose(got_losses, losses, rtol=1e-5, err_msg=name)
            for (path, a), (_, b) in zip(_flat(got_params), _flat(jax.tree_util.tree_map(
                    lambda t: t.numpy(), params))):
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=f"{name} {path}")
        for (_, a), (_, b) in zip(_flat(two_ranks[0]["trainers"][name][1]), _flat(two_ranks[1]["trainers"][name][1])):
            np.testing.assert_array_equal(a, b)
    # the scan over the mesh takes the per-step trajectory
    for (_, a), (_, b) in zip(_flat(two_ranks[0]["trainers"]["train_fast_scan2"][1]),
                              _flat(two_ranks[0]["trainers"]["train_fast_scan0"][1])):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_train_fast_over_two_ranks_replicates_an_odd_hash_table(two_ranks):
    """train_fast replicates its parameters over a mesh, as the JAX
    package's does: a hash table of an odd row count trains over 2 ranks,
    each rank holding all of it, the replicas bitwise equal."""
    rows = FCFGS["hash_odd"].grid.total_params
    assert rows % 2 == 1
    tables = [rank["trainers"]["train_fast_hash"][1]["table"] for rank in two_ranks]
    assert all(t.shape[0] == rows for t in tables)
    np.testing.assert_array_equal(tables[0], tables[1])
    assert len(two_ranks[0]["trainers"]["train_fast_hash"][0]) == TRAIN_STEPS


def test_shard_batch_arrays_matches_jax():
    mesh = jax_make_mesh(2)
    vi, pi, gt = np.arange(8, dtype=np.int32), np.arange(8, dtype=np.int32)[::-1].copy(), np.ones((8, 3), np.float32)
    for r in range(2):
        port = mesh_lib.Mesh(2, r, torch.device("cpu"))
        got = recon._shard_batch_arrays(port, vi, pi, gt)
        assert got[0].dtype == torch.int64 and got[2].dtype == torch.float32
        for a, x in zip(got, (vi, pi, gt)):
            placed = jax.device_put(jnp.asarray(x), jax_data_sharding(mesh, np.ndim(x)))
            want = [np.asarray(x[s.index]) for s in placed.addressable_shards if s.device == mesh.devices.flatten()[r]]
            np.testing.assert_array_equal(a.numpy(), want[0])


@pytest.mark.skipif(not os.path.exists(bench.ARTIFACT_CKPT), reason="artifact not present")
def test_cli_mesh_devices_writes_the_one_process_files(tmp_path):
    torch_mesh_ranks.cli_files_over_ranks(tmp_path, "parity")


def test_cli_mesh_devices_refuses_an_uneven_frame(tmp_path):
    with pytest.raises(SystemExit, match="does not divide"):
        cli.main(torch_mesh_ranks.CLI_ARGS + ["--sampler", "fast", "--mesh_devices", "5", "--out_dir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "canonical_360")
