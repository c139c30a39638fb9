"""The reconstruction slice of the PyTorch port against the JAX package, on
the CPU: the dataset's training samplers, the supersampled rays, the 64+64
trainer (``setup``/``train``) on the hash grid, the fast trainer with
``view_ids``, callbacks and a save-and-resume, mesh extraction and export,
and ``reconstruct_cli`` end to end on a tiny set for both samplers, with
its refusals and a resume from the JAX package's orbax train state
(``--scan_steps`` runs: tests/test_torch_scan_train.py).

Tolerances:
* the samplers: exact where both sides compute in numpy (pixel draws,
  ground truth, masks, the silhouette's keep mask, ray origins); ray
  directions and sphere bounds 1e-6 (f32 normalisation and a 3x3 product
  in another order), as tests/test_torch_dataset.py holds dataset_rays;
* supersampled rays: 1e-6, as tests/test_torch_train.py holds the ray
  function;
* the 64+64 trainer, 3 steps under SGD 5e-2 (both packages' optimizer
  replaced, as tests/test_torch_train.py does for the fast trainer), no
  perturbation (the port's depths come from a torch.Generator where JAX
  splits keys): losses 1e-4 relative, every leaf of the trained tree 1e-5
  absolute;
* the fast trainer under its own Adam from one initial field: losses 1e-4
  relative (tests/test_torch_train.py's 40-step bound), grids within the
  refresh bound 512^2/4 x 1e-6 of tests/test_torch_train.py;
* the SDF lattice of extract_geometry: 1e-5 absolute (f32 MLP sums in
  another order); the mesh, from one lattice, exactly as the JAX package's
  native extractor gives it (both take the native route), and the same
  triangle count and vertex set as the numpy plain version; the PLY bytes
  exactly.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from avatarcraft_tpu.data import SMPLMultiviewDataset as JaxDataset
from avatarcraft_tpu.models import instant_nsr as jnsr
from avatarcraft_tpu.ops.grid_encoder import PyramidSpec as JaxPyramidSpec
from avatarcraft_tpu.ops.hash_encoder import HashGridSpec as JaxHashGridSpec
from avatarcraft_tpu.utils import marching_cubes as jmc
from avatarcraft_tpu.utils import native as jnative
from avatarcraft_tpu.utils import mesh_export as jmesh
from avatarcraft_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from avatarcraft_tpu.workloads import reconstruct as jrecon
from avatarcraft_tpu_torch.cli import reconstruct_cli
from avatarcraft_tpu_torch.data import SMPLMultiviewDataset
from avatarcraft_tpu_torch.models import instant_nsr as nsr
from avatarcraft_tpu_torch.utils import mesh_export
from avatarcraft_tpu_torch.utils.checkpoint import (
    leaves,
    load_params_with_config,
    load_train_state,
    map_leaves,
    params_from_jax,
    train_state_from_optax,
)
from avatarcraft_tpu_torch.workloads import reconstruct as recon
from test_torch_dataset import write_blender_set
from test_torch_render_parity import HASH_FCFG, HASH_JAX_FCFG, hash_field

GRID_ATOL = 512.0**2 / 4 * 1e-6
HASH_KW = dict(num_levels=4, log2_hashmap_size=10, base_resolution=4, desired_resolution=32)
TINY_HASH_JAX = jnsr.FieldConfig(encoder="hashgrid", grid=JaxHashGridSpec(**HASH_KW))
TINY_HASH = nsr.FieldConfig(encoder="hashgrid", grid=nsr.HashGridSpec(**HASH_KW))
TINY_PYR_JAX = jnsr.FieldConfig(
    encoder="tpu_pyramid", packed_dtype="float32",
    pyramid=JaxPyramidSpec(grid_resolutions=(8, 16), grid_dim=2, plane_resolutions=(33,), plane_dim=2),
)
TINY_PYR = nsr.FieldConfig(
    encoder="tpu_pyramid", packed_dtype="float32",
    pyramid=nsr.PyramidSpec(grid_resolutions=(8, 16), grid_dim=2, plane_resolutions=(33,), plane_dim=2),
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work (tier-1 runs six
    pytest workers on the machine's cores). Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def disc_set(tmp_path_factory):
    """4 views at 16x16 of a white disc on black, cameras at distance 2
    around the y axis (tests/test_reconstruct.py's set, two more views)."""
    root = str(tmp_path_factory.mktemp("disc"))
    poses, images = [], []
    for angle in (0.0, np.pi / 2, np.pi, 1.5 * np.pi):
        c, s = np.cos(angle), np.sin(angle)
        poses.append(np.array([[c, 0, s, 2 * s], [0, 1, 0, 0], [-s, 0, c, 2 * c], [0, 0, 0, 1]], np.float32))
        img = np.zeros((16, 16, 3), np.uint8)
        yy, xx = np.mgrid[:16, :16]
        img[(yy - 8) ** 2 + (xx - 7) ** 2 < 25] = 255
        images.append(img)
    write_blender_set(root, np.stack(images), np.stack(poses), camera_angle_x=1.0471975511965976)
    return root


def test_training_samplers_match_jax(disc_set):
    port, ref = SMPLMultiviewDataset(disc_set), JaxDataset(disc_set)
    for g, w in zip(port.all_pixels(), ref.all_pixels()):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    vi, pi = np.array([0, 3, 1, 2], np.int32), np.array([0, 17, 255, 100], np.int32)
    np.testing.assert_array_equal(port.gather_rgb(vi, pi), ref.gather_rgb(vi, pi))
    np.testing.assert_array_equal(port.gather_mask(vi, pi), ref.gather_mask(vi, pi))
    for g, w in zip(port.gen_rays_at(2, 2, device="cpu"), ref.gen_rays_at(2, 2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)

    got = port.gen_random_rays_at(1, 50, np.random.default_rng(9), device="cpu")
    want = ref.gen_random_rays_at(1, 50, np.random.default_rng(9))
    for name, g, w in zip(("rays_o", "rays_d", "rgb", "mask"), got, want):
        assert g.shape == np.asarray(w).shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6 if name == "rays_d" else 0, rtol=0, err_msg=name)
    assert got[3].sum() > 0  # some draws hit the disc

    near, far = port.near_far_from_sphere(got[0], got[1])
    wn, wf = ref.near_far_from_sphere(want[0], want[1])
    np.testing.assert_allclose(near.numpy(), np.asarray(wn), atol=1e-6, rtol=0)
    np.testing.assert_allclose(far.numpy(), np.asarray(wf), atol=1e-6, rtol=0)

    for mask in (port.masks[0] > 0, np.zeros((16, 16), bool)):
        g = port.gen_rays_silhouettes(port.poses[0], 64, mask, device="cpu")
        w = ref.gen_rays_silhouettes(ref.poses[0], 64, mask)
        assert g[2] == w[2]
        np.testing.assert_array_equal(g[3], w[3])
        for a, b in zip(g[:2], w[:2]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)


def test_pixel_batches_view_ids_and_ss_rays_match_jax(rng):
    view_ids = np.array([0, 2, 3], np.int32)
    a = list(jrecon.pixel_batches(4, 30, 16, np.random.default_rng(5), view_ids))
    b = list(recon.pixel_batches(4, 30, 16, np.random.default_rng(5), view_ids))
    assert len(a) == len(b) == 5
    for (va, pa), (vb, pb) in zip(a, b):
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(pa, pb)
        assert set(vb) <= {0, 2, 3} and va.dtype == vb.dtype
    K = np.array([[20.0, 0, 8.0], [0, 21.0, 7.5], [0, 0, 1]], np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * 3)
    poses[:, :3, :3] = np.linalg.qr(rng.normal(size=(3, 3, 3)))[0].astype(np.float32)
    poses[:, :3, 3] = rng.normal(size=(3, 3)).astype(np.float32)
    vi = rng.integers(0, 3, 20).astype(np.int32)
    pi = rng.integers(0, 16 * 16, 20).astype(np.int32)
    for ss in (1, 2, 3):
        want = jax.jit(jrecon.make_batch_ray_fn_ss(K, 16, 16, ss))(poses, vi, pi)
        got = recon.make_batch_ray_fn_ss(K, 16, 16, ss)(_t(poses), _t(vi).long(), _t(pi).long())
        for g, w in zip(got, want):
            assert g.shape == (20 * ss * ss, 3)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


def _jax_init(jcfg, seed=42):
    return jax.tree_util.tree_map(np.asarray, jnsr.init_field_params(jax.random.PRNGKey(seed), jcfg))


def test_train_hashgrid_three_steps_match_jax(disc_set, monkeypatch):
    """setup + train, 3 steps of the 64+64 trainer on the hash grid
    (12 + 8 samples, fd7), from the JAX init carried across, under SGD."""
    rcfg_kw = dict(num_steps=12, upsample_steps=8, upsample_round=8, bound=1.6, perturb=False)
    ds_j, ds = JaxDataset(disc_set), SMPLMultiviewDataset(disc_set)
    monkeypatch.setattr(jrecon, "make_optimizer", lambda cfg, spe: __import__("optax").sgd(5e-2))
    jcfg = jrecon.ReconstructConfig(batch_size=64, epochs=1, white_bkg=False)
    jparams, jstats = jrecon.train(ds_j, TINY_HASH_JAX, jnsr.RenderConfig(**rcfg_kw), jcfg, max_steps=3, log_every=1)

    init = _jax_init(TINY_HASH_JAX)
    monkeypatch.setattr(recon, "init_field_params", lambda gen, fcfg: params_from_jax(init, device="cpu"))
    monkeypatch.setattr(recon, "make_optimizer", lambda cfg, spe, ps: (torch.optim.SGD(ps, lr=5e-2), None))
    seen = []
    cfg = recon.ReconstructConfig(batch_size=64, epochs=1, white_bkg=False)
    params, stats = recon.train(ds, TINY_HASH, nsr.RenderConfig(**rcfg_kw), cfg, max_steps=3, log_every=1,
                                device="cpu", callbacks={"on_step": lambda s, p, l: seen.append((s, sorted(p())))})
    assert [s for s, _ in seen] == [0, 1, 2] and seen[0][1] == ["color", "sdf", "table", "variance"]
    assert [s for s, _ in stats["losses"]] == [s for s, _ in jstats["losses"]] == [0, 1, 2]
    np.testing.assert_allclose([l for _, l in stats["losses"]], [l for _, l in jstats["losses"]], rtol=1e-4)
    assert stats["steps"] == 3 and stats["steps_per_sec"] > 0
    got = jax.tree_util.tree_flatten_with_path(map_leaves(params, lambda t: t.numpy()))[0]
    want = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, jparams))[0]
    assert len(got) == len(want)
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=jax.tree_util.keystr(path))
    assert np.abs(params["table"].numpy() - init["table"]).max() > 0  # the table trained


def test_train_resume_from_carried_state_matches_jax(disc_set, tmp_path):
    """The 64+64 trainer resumed from one state in both packages: a hash
    field and optax Adam moments after two updates, saved by the JAX
    package (orbax) and carried across (train_state_from_optax; the JAX
    tree's keys come sorted, the port's init tree's do not). Two more
    steps under Adam: losses 1e-4 relative; the step count restarts at 0
    in both (the JAX package's train resumes parameters and Adam only)."""
    import optax

    from avatarcraft_tpu.workloads.reconstruct import save_train_state as jax_save_train_state

    rcfg_kw = dict(num_steps=12, upsample_steps=8, upsample_round=8, bound=1.6, perturb=False)
    ds_j, ds = JaxDataset(disc_set), SMPLMultiviewDataset(disc_set)
    jcfg = jrecon.ReconstructConfig(batch_size=64, epochs=1, white_bkg=False)
    rng = np.random.default_rng(11)
    params = _jax_init(TINY_HASH_JAX, seed=7)
    params["table"] = (rng.normal(size=params["table"].shape) * 0.03).astype(np.float32)
    tx = jrecon.make_optimizer(jcfg, ds_j.n_images * 256 // 64)
    opt_state = tx.init(params)
    for _ in range(2):
        g = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32) * 1e-2, params)
        updates, opt_state = tx.update(g, opt_state, params)
        params = jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, updates))
    jdir = str(tmp_path / "jax_state")
    jax_save_train_state(jdir, params, opt_state, 2)
    _, jstats = jrecon.train(ds_j, TINY_HASH_JAX, jnsr.RenderConfig(**rcfg_kw), jcfg, max_steps=2, log_every=1,
                             resume_from=jdir)

    adam = opt_state[0]
    carried = str(tmp_path / "carried.pt")
    train_state_from_optax(carried, params, jax.tree_util.tree_map(np.asarray, adam.mu),
                           jax.tree_util.tree_map(np.asarray, adam.nu), int(adam.count), 2)
    cfg = recon.ReconstructConfig(batch_size=64, epochs=1, white_bkg=False)
    _, stats = recon.train(ds, TINY_HASH, nsr.RenderConfig(**rcfg_kw), cfg, max_steps=2, log_every=1,
                           resume_from=carried, device="cpu")
    assert [s for s, _ in stats["losses"]] == [s for s, _ in jstats["losses"]] == [0, 1]
    np.testing.assert_allclose([l for _, l in stats["losses"]], [l for _, l in jstats["losses"]], rtol=1e-4)


def _fast_kw(**extra):
    return dict(grid_update_every=2, grid_warmup_steps=2, grid_resolution=17, log_every=1, **extra)


def test_train_fast_view_ids_callbacks_and_resume_match_jax(disc_set, tmp_path, monkeypatch):
    """JAX: 4 steps on views 0, 1, 3 saving its state every 2 steps, then a
    resume from its step-4 state to step 6. The port: the same 4 steps from
    the JAX init, with a callback; then a resume from JAX's step-4 state,
    carried across (train_state_from_optax), to step 6. Both resumes
    restart the pixel order from the seed (the JAX package's semantics),
    so the resumed steps 4-5 are not the uninterrupted run's steps 4-5,
    which the port's 6-step run shows."""
    fast_j = jnsr.FastRenderConfig(n_probes=32, k_samples=12, bound=1.6)
    fast = nsr.FastRenderConfig(n_probes=32, k_samples=12, bound=1.6)
    cfg_kw = dict(batch_size=64, epochs=3, white_bkg=False, bkg_mode="composite")
    view_ids = np.array([0, 1, 3], np.int32)
    ds_j, ds = JaxDataset(disc_set), SMPLMultiviewDataset(disc_set)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jcfg = jrecon.ReconstructConfig(**cfg_kw)
    _, _, ja = jrecon.train_fast(ds_j, TINY_PYR_JAX, fast_j, jcfg, max_steps=4, view_ids=view_ids, state_dir=jdir,
                                 save_state_every=2, **_fast_kw())
    _, jgrid, jb = jrecon.train_fast(ds_j, TINY_PYR_JAX, fast_j, jcfg, max_steps=6, view_ids=view_ids,
                                     resume_from=f"{jdir}/state_latest", **_fast_kw())

    init = _jax_init(TINY_PYR_JAX)
    monkeypatch.setattr(recon, "init_field_params", lambda gen, fcfg: params_from_jax(init, device="cpu"))
    cfg = recon.ReconstructConfig(**cfg_kw)
    seen = []

    def on_step(step, params, loss, grid):
        seen.append((step, float(loss), float(grid.max())))

    _, _, pa = recon.train_fast(ds, TINY_PYR, fast, cfg, max_steps=4, view_ids=view_ids, state_dir=pdir,
                                save_state_every=2, callbacks={"on_step": on_step}, device="cpu", **_fast_kw())
    np.testing.assert_allclose([l for _, l in pa["losses"]], [l for _, l in ja["losses"]], rtol=1e-4)
    assert [s for s, _, _ in seen] == [0, 1, 2, 3] and seen[0][2] == 100.0 and seen[1][2] < 100.0
    # the JAX trainer's names, as orbax directories (they were state_*.pt files)
    assert sorted(os.listdir(pdir)) == ["state_final", "state_latest"]
    assert all(os.path.isfile(os.path.join(pdir, d, "manifest.ocdbt")) for d in os.listdir(pdir))
    mine = load_train_state(f"{pdir}/state_latest", "cpu")
    assert mine["step"] == 4 and mine["count"] == 4 and mine["grid"].shape == (17, 17, 17)

    # JAX's step-4 state, read back and carried across
    tx = jrecon.make_optimizer(jcfg, ds_j.n_images * 256 // 64)
    like = {"params": init, "opt_state": tx.init(init), "grid": np.zeros((17,) * 3, np.float32), "step": 0}
    state = jax_load_checkpoint(f"{jdir}/state_latest", like)
    # the port's step-4 state restores in JAX as JAX's own: the same tree,
    # dtypes and shapes, the step and optax's counts
    port_state = jax_load_checkpoint(f"{pdir}/state_latest", like)
    assert jax.tree_util.tree_structure(port_state) == jax.tree_util.tree_structure(state)
    for a, b in zip(jax.tree_util.tree_leaves(port_state), jax.tree_util.tree_leaves(state)):
        assert np.asarray(a).dtype == np.asarray(b).dtype and np.shape(a) == np.shape(b)
    assert port_state["step"] == state["step"] == 4
    assert [int(s.count) for s in port_state["opt_state"]] == [int(s.count) for s in state["opt_state"]] == [4, 4]
    adam = state["opt_state"][0]
    carried = str(tmp_path / "carried.pt")
    train_state_from_optax(carried, jax.tree_util.tree_map(np.asarray, state["params"]),
                           jax.tree_util.tree_map(np.asarray, adam.mu), jax.tree_util.tree_map(np.asarray, adam.nu),
                           int(adam.count), int(state["step"]), np.asarray(state["grid"]))
    _, grid, pb = recon.train_fast(ds, TINY_PYR, fast, cfg, max_steps=6, view_ids=view_ids, resume_from=carried,
                                   device="cpu", **_fast_kw())
    assert [s for s, _ in pb["losses"]] == [s for s, _ in jb["losses"]] == [4, 5]
    np.testing.assert_allclose([l for _, l in pb["losses"]], [l for _, l in jb["losses"]], rtol=1e-4)
    np.testing.assert_allclose(grid.numpy(), np.asarray(jgrid), atol=GRID_ATOL, rtol=0)
    # the port's own state resumes the same way, in the port and in JAX
    _, _, pc = recon.train_fast(ds, TINY_PYR, fast, cfg, max_steps=6, view_ids=view_ids,
                                resume_from=f"{pdir}/state_latest", device="cpu", **_fast_kw())
    np.testing.assert_allclose([l for _, l in pc["losses"]], [l for _, l in jb["losses"]], rtol=1e-4)
    _, _, jc = jrecon.train_fast(ds_j, TINY_PYR_JAX, fast_j, jcfg, max_steps=6, view_ids=view_ids,
                                 resume_from=f"{pdir}/state_latest", **_fast_kw())
    assert [s for s, _ in jc["losses"]] == [4, 5]
    np.testing.assert_allclose([l for _, l in jc["losses"]], [l for _, l in jb["losses"]], rtol=1e-4)
    _, _, full = recon.train_fast(ds, TINY_PYR, fast, cfg, max_steps=6, view_ids=view_ids, device="cpu", **_fast_kw())
    assert [l for s, l in full["losses"] if s >= 4] != [l for _, l in pb["losses"]]


def test_extract_geometry_and_save_ply_match_jax(tmp_path):
    jparams, params = hash_field()
    want_grid = jnsr.extract_sdf_grid(jparams, HASH_JAX_FCFG, 1.6, 20, block=7)
    got_grid = nsr.extract_sdf_grid(params, HASH_FCFG, 1.6, 20, block=7)
    np.testing.assert_allclose(got_grid, want_grid, atol=1e-5, rtol=0)
    assert got_grid.min() < 0 < got_grid.max()  # a surface crosses the lattice
    verts, tris = nsr.extract_geometry(params, HASH_FCFG, 1.6, 20)
    v_ref, t_ref = jnative.native_marching_cubes(-got_grid, 0.0)
    np.testing.assert_array_equal(verts, (v_ref / 19.0 * 3.2 - 1.6).astype(np.float32))
    np.testing.assert_array_equal(tris, t_ref)
    v_np, t_np = jmc.marching_cubes(-got_grid, 0.0, prefer_native=False)
    assert len(t_np) == len(tris)
    np.testing.assert_allclose(np.unique(np.round(v_np, 4), axis=0), np.unique(np.round(v_ref, 4), axis=0), atol=1e-4)
    assert len(tris) > 100 and np.abs(verts).max() <= 1.6
    wv, wt = jnsr.extract_geometry(jparams, HASH_JAX_FCFG, 1.6, 20)
    assert abs(len(wt) - len(tris)) <= 0.02 * len(tris)  # JAX's own (native) extractor, its lattice
    a, b = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    mesh_export.save_ply(verts, tris, a)
    jmesh.save_ply(verts, tris, b)
    assert open(a, "rb").read() == open(b, "rb").read()


def _small_field_config(monkeypatch):
    """The CLI builds FieldConfig(encoder=...) at the reference's widths;
    the CPU test runs it at the tiny widths above (its encoder kept)."""
    real = nsr.FieldConfig

    def small(encoder):
        return TINY_HASH if encoder == "hashgrid" else dataclasses.replace(TINY_PYR, packed_dtype="bfloat16")

    monkeypatch.setattr(nsr, "FieldConfig", small)
    return real


@pytest.mark.parametrize("sampler", ["parity", "fast"])
def test_cli_end_to_end(disc_set, tmp_path, monkeypatch, capsys, sampler):
    _small_field_config(monkeypatch)
    out = tmp_path / "out"
    argv = ["--data_path", disc_set, "--use_cuda", "false", "--out_dir", str(out), "--exp_name", "r",
            "--sampler", sampler, "--batch_size", "64", "--max_steps", "4", "--i_val", "2", "--i_save", "4",
            "--i_mesh", "4", "--mesh_resolution", "16", "--save_state_every", "2", "--grid_warmup_steps", "2"]
    params, stats = reconstruct_cli.main(argv)
    printed = capsys.readouterr().out
    assert printed.strip().splitlines()[-1].startswith("done: 4 steps, ")
    assert "steps/s" in printed.strip().splitlines()[-1] and "rays/s" in printed.strip().splitlines()[-1]
    files = set(os.listdir(out / "r"))
    want = {"r_args.txt", "r_0002.png", "r_0004.png", "r_0004.pth.tar", "r_0004.pth.tar.fieldcfg.json",
            "r_0004.ply", "r_final.pth.tar", "r_final.pth.tar.fieldcfg.json"}
    if sampler == "fast":
        want |= {"r_grid.npy", "state_latest", "state_final"}  # orbax directories, the JAX CLI's names
    assert files == want
    loaded, fcfg = load_params_with_config(str(out / "r" / "r_final.pth.tar"), device="cpu")
    assert fcfg.encoder == ("hashgrid" if sampler == "parity" else "tpu_pyramid")
    assert all(torch.equal(a, b) for a, b in zip(leaves(loaded), leaves(params)))
    assert all(np.isfinite(l) for _, l in stats["losses"])
    with open(out / "r" / "r_0004.ply", "rb") as fp:
        assert fp.read(3) == b"ply"
    if sampler == "fast":
        grid = np.load(out / "r" / "r_grid.npy")
        assert grid.shape == (129, 129, 129) and np.isfinite(grid).all()
        # a resume from the final state (step 4) to step 6
        _, resumed = reconstruct_cli.main(argv[:-8] + ["--max_steps", "6", "--i_mesh", "100", "--resume_from",
                                                       str(out / "r" / "state_final")])
        assert resumed["steps"] == 6


REFUSALS = [
    (["--data_format", "neuman"], "neuman"),
    (["--normal_mode", "analytic"], "render-time option"),
]


@pytest.mark.parametrize("argv,msg", REFUSALS)
def test_cli_refusals_write_nothing(tmp_path, argv, msg):
    out = tmp_path / "out"
    with pytest.raises(SystemExit, match=msg):
        reconstruct_cli.main(["--data_path", str(tmp_path), "--use_cuda", "false", "--out_dir", str(out)] + argv)
    assert not out.exists()


def test_cli_resume_from_jax_orbax_state_matches_jax(disc_set, tmp_path, monkeypatch, capsys):
    """reconstruct_cli --resume_from DIR, refused before the orbax reader,
    on the train state that JAX's train_fast wrote at step 4 (an orbax
    directory: parameters, optax's Adam state, the grid, the step): the
    CLI's fast trainer resumes to step 6 as JAX's train_fast resumes from
    the same directory, losses within 1e-4 relative
    (test_train_resume_from_carried_state_matches_jax's tolerance). The
    CLI's --implicit_model neus is parsed and not read, as in the JAX
    package, and one line says so."""
    import functools

    _small_field_config(monkeypatch)
    fcfg_j = dataclasses.replace(TINY_PYR_JAX, packed_dtype="bfloat16")
    fast_j = jnsr.FastRenderConfig(n_probes=128, k_samples=32, bound=1.6, normal_mode="fd4")
    jcfg = jrecon.ReconstructConfig(batch_size=64, lr=5e-4, epochs=2, white_bkg=True, bkg_mode="raw")
    ds_j, jdir = JaxDataset(disc_set), str(tmp_path / "jax")
    jrecon.train_fast(ds_j, fcfg_j, fast_j, jcfg, max_steps=4, state_dir=jdir, save_state_every=2)
    _, _, jb = jrecon.train_fast(ds_j, fcfg_j, fast_j, jcfg, max_steps=6, log_every=1,
                                 resume_from=f"{jdir}/state_latest")
    monkeypatch.setattr(recon, "train_fast", functools.partial(recon.train_fast, log_every=1))
    out = tmp_path / "out"
    _, stats = reconstruct_cli.main(["--data_path", disc_set, "--use_cuda", "false", "--out_dir", str(out),
                                     "--exp_name", "r", "--sampler", "fast", "--batch_size", "64", "--max_steps", "6",
                                     "--i_val", "1000", "--i_save", "1000", "--i_mesh", "1000", "--implicit_model",
                                     "neus", "--resume_from", f"{jdir}/state_latest"])
    assert "[reconstruct] --implicit_model neus has no effect here" in capsys.readouterr().out
    assert [s for s, _ in stats["losses"]] == [s for s, _ in jb["losses"]] == [4, 5]
    np.testing.assert_allclose([l for _, l in stats["losses"]], [l for _, l in jb["losses"]], rtol=1e-4)


def test_cli_parser_matches_jax():
    from avatarcraft_tpu.cli import reconstruct_cli as jcli

    def flags(parser):
        return {a.dest: (a.default, tuple(a.choices) if a.choices else None) for a in parser._actions
                if a.dest not in ("help", "use_cuda", "platform")}

    want, got = flags(jcli.build_parser()), flags(reconstruct_cli.build_parser())
    assert got == {k: v for k, v in want.items() if k in got}
    assert set(want) - set(got) <= {"tpu_generation"}, set(want) - set(got)


def test_default_background_keeps_the_references_inconsistency(disc_set, monkeypatch):  # noqa: F811
    """A known fault of the reference, kept and named: the JAX package's
    ReconstructConfig (workloads/reconstruct.py:53-58) defaults to
    white_bkg=True with bkg_mode="raw", so on a black-backed set
    (smpl_da_512's layout, as this disc set) the raw images, black off the
    body, are compared with renders on white; JAX's own comment calls it
    inconsistent. The port keeps JAX's defaults, in its ReconstructConfig
    and in reconstruct_cli's --white_bkg and --bkg_mode, and its fast step
    at those defaults renders on white against that black ground truth.
    (finetune_ss renders on black against the same raw images, as JAX's
    tools/finetune_ss.py:118-120 does, and so avoids it:
    tests/test_torch_finetune.py::test_finetune_ss_matches_jax.)"""
    assert dataclasses.asdict(recon.ReconstructConfig()) == dataclasses.asdict(jrecon.ReconstructConfig())
    assert (recon.ReconstructConfig().white_bkg, recon.ReconstructConfig().bkg_mode) == (True, "raw")
    opt = reconstruct_cli.build_parser().parse_args([])
    assert (opt.white_bkg, opt.bkg_mode) == (True, "raw")
    ds = SMPLMultiviewDataset(disc_set)
    off = ds.masks == 0
    assert off.any() and not ds.images[off].any()  # black where the body is not
    seen = []
    real = recon.render_rays_fast

    def record(*a, **kw):
        seen.append(a[6])  # the background the step renders on
        return real(*a, **kw)

    monkeypatch.setattr(recon, "render_rays_fast", record)
    recon.train_fast(ds, TINY_PYR, nsr.FastRenderConfig(n_probes=16, k_samples=8, bound=1.6),
                     recon.ReconstructConfig(batch_size=64), max_steps=1, grid_resolution=9, device="cpu")
    assert seen == [1.0]
