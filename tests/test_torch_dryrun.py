"""The port's dryrun twin (parallel/dryrun.py::dryrun_multichip) over 4
ranks on the CPU against the JAX package's dryrun (__graft_entry__.py:39-430)
on 4 of the conftest's 8 CPU devices, path by path, on the same parameters
(JAX's init_field_params, carried across) and the same numpy draws.

The port's run holds its own checks (the n-rank paths against one process,
raising inside); these tests hold its quantities to JAX's. The 64+64 paths
run without jitter on both sides (JAX draws its jitter from jax.random keys,
the port from a torch generator; the port's jitter blocks are held by the
dryrun's own n-rank against one-process check with jitter on, in
tests/test_torch_mesh.py's trainers and on the card).

Tolerances and their causes:
* losses: 1e-5 relative (f32 sums in XLA's order and the port's);
* parameters after one Adam step (batch, fast, phase B): Adam's first step
  is lr g / (|g| + eps), lr sign(g) where |g| >> eps, so a parameter whose
  gradient is above 1e-3 x its leaf's max|g| and above 1e3 eps agrees
  within 1e-6, and any other within 2 lr + 1e-6 (a near-zero gradient's
  sign may differ, and near eps (1e-8 in phase B's Adam) a 1% difference of
  a gradient that cancels to 1e-7 moves the step by 6e-6, as measured);
* the scan: its losses at JAX's dryrun pin, 1e-5;
* the frames (rays sharded, per-rank budgets that clip nothing, against
  JAX's frame without a budget): 2e-5, the pin of the port's fast frames
  against JAX's (tests/test_torch_warp_render.py);
* multi-prompt gradients: 1e-6 x the prompt's max|g| plus 1e-9;
* table-MP: loss 1e-5 relative, leaves 3e-5, tests/test_table_mp.py's pins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from avatarcraft_tpu.models import instant_nsr as jnsr
from avatarcraft_tpu.models.smpl import synthetic_smpl_params as jax_synthetic_smpl_params
from avatarcraft_tpu.ops.grid_encoder import PyramidSpec as JaxPyramidSpec
from avatarcraft_tpu.ops.hash_encoder import HashGridSpec as JaxHashGridSpec
from avatarcraft_tpu.ops.occupancy import voxelize_verts as jax_voxelize_verts
from avatarcraft_tpu.parallel.mesh import data_sharding, make_mesh, replicate
from avatarcraft_tpu.parallel.table_mp import make_table_mp_train_step, shard_grid_rows as jax_shard_grid_rows
from avatarcraft_tpu.warp import WarpData as JaxWarpData, make_warp_fn as jax_make_warp_fn
from avatarcraft_tpu.workloads import reconstruct as jrecon
from avatarcraft_tpu.workloads.multi_stylize import _phaseB_grads_fast as jax_phaseB_grads_fast
from avatarcraft_tpu.workloads.stylize import StylizeConfig as JaxStylizeConfig, make_phaseB_step as jax_phaseB
from avatarcraft_tpu.workloads.warp_render import calc_local_trans as jax_calc_local_trans
from avatarcraft_tpu_torch.parallel import dryrun
from avatarcraft_tpu_torch.parallel.table_mp import shard_grid_rows
from avatarcraft_tpu_torch.utils.checkpoint import leaves, params_from_jax

N = 4
B = 8 * N
JFCFG = jnsr.FieldConfig(grid=JaxHashGridSpec(num_levels=4, base_resolution=4, log2_hashmap_size=10,
                                              desired_resolution=32))
JFCFG_FAST = jnsr.FieldConfig(
    encoder="tpu_pyramid",
    pyramid=JaxPyramidSpec(grid_resolutions=(4, 8), grid_dim=2, plane_resolutions=(17,), plane_dim=2),
    packed_dtype="float32",
)
FRAME_ATOL = 2e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return [(jax.tree_util.keystr(p), np.asarray(a)) for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_tree(jtree):
    """A JAX parameter tree carried to the port's layout, as numpy."""
    return jax.tree_util.tree_map(lambda t: t.numpy(), params_from_jax(_np(jtree), "cpu"))


@pytest.fixture(scope="module")
def jax_inputs():
    init = lambda cfg, k: _np(jnsr.init_field_params(jax.random.PRNGKey(k), cfg))  # noqa: E731
    s = dryrun.SEEDS
    return {
        "batch": init(JFCFG, s["batch"]),
        "fast": init(JFCFG_FAST, s["fast"]),
        "stylize": init(JFCFG, s["stylize"]),
        "multi_gt": init(JFCFG_FAST, s["multi_gt"]),
        "table_mp": init(JFCFG_FAST, s["table_mp"]),
        "multi": [init(JFCFG_FAST, dryrun.MULTI_SEED + i) for i in range(N)],
    }


@pytest.fixture(scope="module")
def port(jax_inputs):
    inputs = {k: ([_port_tree(t) for t in v] if k == "multi" else _port_tree(v)) for k, v in jax_inputs.items()}
    return dryrun.dryrun_multichip(N, "cpu", inputs=inputs, perturb=False)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(N)


@pytest.fixture(scope="module")
def data():
    return dryrun.batch_data(N)


def _sh(mesh, x):
    return jax.device_put(jnp.asarray(x), data_sharding(mesh, np.ndim(x)))


def _hold_adam(port_params, jax_params, grads, lr, eps):
    for (path, a), (_, b), (_, g) in zip(_flat(port_params), _flat(jax_params), _flat(grads)):
        assert a.shape == b.shape == g.shape, path
        big = np.abs(g) > max(1e-3 * float(np.abs(g).max()), 1e3 * eps)
        np.testing.assert_allclose(a[big], b[big], atol=1e-6, rtol=0, err_msg=path)
        np.testing.assert_allclose(a, b, atol=2 * lr + 1e-6, rtol=0, err_msg=path)


def _poses():
    return dryrun._poses()


def test_every_path_ran_and_held_its_own_checks(port):
    assert list(port["results"]) == list(dryrun.PATHS)
    assert set(port["launches"]) == set(dryrun.PATHS)
    for path in ("batch", "fast", "stylize"):
        assert port["results"][path]["grad_rel"] <= dryrun.GRAD_REL


def test_batch_step_matches_jax(port, jax_inputs, mesh, data):
    rcfg = jnsr.RenderConfig(num_steps=8, upsample_steps=8, upsample_round=8, perturb=False)
    tx = jrecon.make_optimizer(jrecon.ReconstructConfig(batch_size=B), steps_per_epoch=10)
    step = jrecon.make_train_step(JFCFG, rcfg, tx, jrecon.make_batch_ray_fn(dryrun.K, 16, 16), 0.1, 1.0)
    params = replicate(mesh, jax_inputs["batch"])
    params, _, loss, _ = step(params, replicate(mesh, tx.init(params)), replicate(mesh, jnp.asarray(_poses())),
                              _sh(mesh, data["view_idx"]), _sh(mesh, data["pix_idx"]), _sh(mesh, data["gt"]),
                              jax.random.PRNGKey(1))
    got = port["results"]["batch"]
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    _hold_adam(got["params"], _np(params), got["grads"], 5e-4, 1e-15)


def test_fast_step_matches_jax(port, jax_inputs, mesh, data):
    got = port["results"]["fast"]
    fast_cfg = jnsr.FastRenderConfig(n_probes=16, k_samples=6, bound=1.6, sample_budget=N * got["budget"])
    tx = jrecon.make_optimizer(jrecon.ReconstructConfig(batch_size=B), steps_per_epoch=10)
    step = jrecon.make_train_step_fast(JFCFG_FAST, fast_cfg, tx, jrecon.make_batch_ray_fn(dryrun.K, 16, 16), 0.1, 1.0)
    params = replicate(mesh, jax_inputs["fast"])
    params, _, loss, _ = step(params, replicate(mesh, tx.init(params)), replicate(mesh, jnp.asarray(_poses())),
                              _sh(mesh, data["view_idx"]), _sh(mesh, data["pix_idx"]), _sh(mesh, data["gt"]),
                              replicate(mesh, jnp.full((17, 17, 17), 100.0, jnp.float32)), jax.random.PRNGKey(3),
                              jnp.float32(1.0))
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    _hold_adam(got["params"], _np(params), got["grads"], 5e-4, 1e-15)


def test_stylize_phase_b_matches_jax(port, jax_inputs, mesh, data):
    rcfg = jnsr.RenderConfig(num_steps=6, upsample_steps=6, upsample_round=6, perturb=False)
    tx = optax.adam(5e-3)
    phaseB = jax_phaseB(JFCFG, rcfg, tx, 0.01, True, data["chunk"])
    params = replicate(mesh, jax_inputs["stylize"])
    params, _ = phaseB(params, replicate(mesh, jax_inputs["stylize"]), replicate(mesh, tx.init(params)),
                       _sh(mesh, data["rays_o_s"]), _sh(mesh, data["rays_d_s"]), _sh(mesh, data["g_rgb"]),
                       _sh(mesh, data["bgv"]), jax.random.PRNGKey(5))
    got = port["results"]["stylize"]
    _hold_adam(got["params"], _np(params), got["grads"], 5e-3, 1e-8)


def test_scan_losses_match_jax(port, jax_inputs, mesh, data):
    """S sharded scan steps: the port's losses (held inside against its own
    per-step run) against JAX's scan from the same parameters."""
    got = port["results"]["scan"]
    fast_cfg = jnsr.FastRenderConfig(n_probes=16, k_samples=6, bound=1.6, sample_budget=0)
    tx = jrecon.make_optimizer(jrecon.ReconstructConfig(batch_size=B), steps_per_epoch=10)
    scan = jrecon.make_train_scan_fast(JFCFG_FAST, fast_cfg, tx, jrecon.make_batch_ray_fn(dryrun.K, 16, 16), 0.1,
                                       "composite", True)
    params = replicate(mesh, jax_inputs["fast"])
    sh_sb = NamedSharding(mesh, P(None, "data"))
    _, _, losses = scan(params, replicate(mesh, tx.init(params)), replicate(mesh, jnp.asarray(_poses())),
                        replicate(mesh, jnp.asarray(data["images_flat"])), replicate(mesh, jnp.asarray(data["masks_flat"])),
                        jax.device_put(data["vis"], sh_sb), jax.device_put(data["pis"], sh_sb),
                        replicate(mesh, jnp.full((17, 17, 17), 100.0, jnp.float32)), jax.random.PRNGKey(11))
    np.testing.assert_allclose(got["losses"], np.asarray(losses), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["per_step"], np.asarray(losses), atol=1e-5, rtol=0)


def _jax_frame(mesh, params, grid, warp_fn=None):
    from avatarcraft_tpu.cameras import pose2rays, pose_spherical

    ro, rd = pose2rays(16, 16, pose_spherical(30.0, -10.0, 2.0))
    fast_cfg = jnsr.FastRenderConfig(n_probes=16, k_samples=6, bound=1.6)
    fn = jax.jit(lambda p, o, d: jnsr.render_rays_fast(p, o, d, JFCFG_FAST, fast_cfg, grid, 1.0,
                                                       warp_fn=warp_fn)["rgb"])
    return np.asarray(fn(replicate(mesh, params), _sh(mesh, np.asarray(ro)), _sh(mesh, np.asarray(rd))))


def test_sharded_frame_matches_jax(port, jax_inputs, mesh):
    want = _jax_frame(mesh, jax_inputs["fast"], jnp.full((17, 17, 17), 100.0, jnp.float32))
    np.testing.assert_allclose(port["results"]["frame"]["rgb"], want, atol=FRAME_ATOL, rtol=0)


def test_sharded_warp_frame_matches_jax(port, jax_inputs, mesh):
    body = jax_synthetic_smpl_params(0, n_verts=64, n_joints=6)
    pose_seq = np.asarray(np.random.default_rng(5).normal(scale=0.2, size=(1, 6, 3)), np.float32)
    wv, Ts, _ = jax_calc_local_trans(body, render_type="animate", poses=pose_seq, max_frames=1, rest_pose="zero")
    warp_fn = jax_make_warp_fn(JaxWarpData.create(wv[0], body.faces, Ts[0]), 0.25)
    want = _jax_frame(mesh, jax_inputs["fast"], jax_voxelize_verts(jnp.asarray(wv[0]), 1.6, 17), warp_fn)
    np.testing.assert_allclose(port["results"]["warp"]["rgb"], want, atol=FRAME_ATOL, rtol=0)


def test_prompt_sharded_grads_match_jax(port, jax_inputs, data):
    scfg = JaxStylizeConfig(batch_size=8, sampler="fast")
    fast_cfg = jnsr.FastRenderConfig(n_probes=16, k_samples=6, bound=1.6, sample_budget=4 * B)
    fn = jax.jit(lambda p, g: jax_phaseB_grads_fast(
        p, jax_inputs["multi_gt"], jnp.asarray(data["rays_o_m"]), jnp.asarray(data["rays_d_m"]), g,
        jnp.asarray(data["bg_m"]), jnp.full((17, 17, 17), 100.0, jnp.float32), JFCFG_FAST, fast_cfg, scfg))
    got = port["results"]["multi"]["grads"]
    assert got.shape[0] == N
    for i in range(N):
        tree = params_from_jax(_np(fn(jax_inputs["multi"][i], jnp.asarray(data["g_rgb_m"][i]))), "cpu")
        rest, shards, _ = shard_grid_rows(tree)
        want = np.concatenate([t.numpy().reshape(-1) for t in leaves(rest) + shards])
        np.testing.assert_allclose(got[i], want, atol=1e-6 * np.abs(want).max() + 1e-9, rtol=0, err_msg=f"prompt {i}")


def test_table_mp_matches_jax(port, jax_inputs, mesh, data):
    rcfg = jnsr.RenderConfig(num_steps=6, upsample_steps=6, upsample_round=6, perturb=False)
    tx = optax.sgd(0.5)
    rest, table, splice = jax_shard_grid_rows(jax.tree_util.tree_map(jnp.asarray, jax_inputs["table_mp"]), mesh, -1)
    step = make_table_mp_train_step(mesh, JFCFG_FAST, rcfg, tx, splice, w_eikonal=0.1, bg_value=1.0,
                                    use_pallas=False)
    rest = replicate(mesh, rest)
    opt_table = jax.tree_util.tree_map(lambda x: jax.device_put(x, table.sharding) if x.ndim else x, tx.init(table))
    rest, table, _, _, loss = step(rest, table, replicate(mesh, tx.init(rest)), opt_table,
                                   _sh(mesh, data["rays_o_s"]), _sh(mesh, data["rays_d_s"]), _sh(mesh, data["gt_mp"]),
                                   jax.random.PRNGKey(31))
    got = port["results"]["table_mp"]
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    want = _flat(_np(splice(rest, table.reshape(-1, table.shape[-1]))))
    for (path, a), (_, b) in zip(_flat(got["params"]), want):
        np.testing.assert_allclose(a, b, atol=3e-5, rtol=0, err_msg=path)
