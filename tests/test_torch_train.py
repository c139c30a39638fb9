"""The reconstruction trainer of the PyTorch port against the JAX package,
on the CPU (the JAX side under ``jax.jit``; its trainer on the 8-device
CPU mesh, as tests/test_train_fast.py runs it).

Tolerances:
* gradient of the fast loss, f32 tables: per leaf 1e-4 x max|g| of that
  leaf. f32 sums run in other orders (the encoder's scatter-add, the MLPs'
  matmuls) and the fd4 stencil's backward multiplies them by 1/(4 eps) =
  50: the JAX package's own jit and eager gradients of this loss differ by
  up to 3.9e-5 x max|g| (measured), and the port's by up to 3.9e-5;
* the same with bf16 tables: per table leaf 1e-1 x max|g|, per MLP and
  variance leaf 2e-3 x max|g|. JAX and PyTorch both scatter-add the packed
  tables' cotangent in bf16 (JAX's cotangent of a bf16 table is bf16,
  PyTorch's index_add on a bf16 table adds in bf16), in other orders, and
  one bf16 rounding is 2^-8 = 3.9e-3 relative: the JAX package's own jit
  and eager table gradients differ by up to 1.6e-1 x max|g| (measured),
  the port's from JAX's by up to 4.9e-2; the MLP gradients see features
  one bf16 rounding apart where f32 corner sums round differently (the
  port's from JAX's up to 5.4e-4);
* Adam and its cosine learning rate against optax over 5 steps: 1e-5
  relative (the same formula, bias corrections applied in another order);
* the grid refresh: 0.066 absolute on densities up to 512 (1.3e-4 of the
  maximum). The density 512 sigmoid(-512 sdf) multiplies an SDF difference
  by up to 512^2/4 = 65536 at the surface, and the two SDFs differ in
  their last bits (1e-6 absolute: f32 sums in other orders);
* pixel batches: exact (the same numpy generator);
* a 3-step train_fast under SGD: losses 1e-4 relative;
* a 40-step train_fast under the trainer's own Adam, with the on-card
  check's schedule (warmup 20, refresh every 20): losses 1e-4 relative
  (measured 6.6e-7: every leaf of the tiny field has gradients well above
  eps, so Adam does not amplify the order of the sums), the grid within
  the refresh bound above.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avatarcraft_tpu.models import instant_nsr as jnsr
from avatarcraft_tpu.ops import occupancy as jocc
from avatarcraft_tpu.ops.grid_encoder import PyramidSpec as JaxPyramidSpec
from avatarcraft_tpu.workloads import reconstruct as jrecon
from avatarcraft_tpu_torch.models import instant_nsr as nsr
from avatarcraft_tpu_torch.ops import occupancy as occ
from avatarcraft_tpu_torch.utils.checkpoint import leaves, map_leaves
from avatarcraft_tpu_torch.utils.checkpoint import adam_state_from_optax, params_from_jax
from avatarcraft_tpu_torch.workloads import reconstruct as recon

GRID_ATOL = 512.0**2 / 4 * 1e-6

JAX_FCFG = jnsr.FieldConfig(
    encoder="tpu_pyramid",
    pyramid=JaxPyramidSpec(grid_resolutions=(4, 8), grid_dim=2, plane_resolutions=(17,), plane_dim=2),
    packed_dtype="float32",
)


def _port_fcfg(jcfg):
    return nsr.FieldConfig(**{
        **dataclasses.asdict(jcfg),
        "grid": nsr.HashGridSpec(**dataclasses.asdict(jcfg.grid)),
        "pyramid": nsr.PyramidSpec(**dataclasses.asdict(jcfg.pyramid)),
    })


def _t(a):
    return torch.from_numpy(np.array(a))


def _field(seed=0):
    """A small field whose SDF depends on the tables (random first-layer
    weights over the encoding, rough tables) and has a surface (bias -1)."""
    rng = np.random.default_rng(seed)
    jparams = jnsr.init_field_params(jax.random.PRNGKey(seed), JAX_FCFG)
    for key in ("grids", "planes"):
        jparams[key] = [jnp.asarray(rng.normal(size=t.shape).astype(np.float32) * 0.3) for t in jparams[key]]
    v = rng.normal(size=jparams["sdf"][0]["v"].shape).astype(np.float32) * 0.3
    jparams["sdf"][0] = {**jparams["sdf"][0], "v": jnp.asarray(v), "g": jnp.linalg.norm(v, axis=1)}
    jparams["sdf"][-1]["b"] = jparams["sdf"][-1]["b"].at[0].add(-1.0)
    return jparams


def _scene(rng, n_rays, R=17):
    grid = np.where(rng.random((R, R, R)) < 0.6, 50.0, 0.5).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32) * 0.25 + np.asarray([0, 0, 1], np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.tile(np.asarray([[0.1, -0.2, -2.6]], np.float32), (n_rays, 1))
    gt = rng.random((n_rays, 3)).astype(np.float32)
    return grid, o, d.astype(np.float32), gt


@pytest.mark.parametrize("packed_dtype,rel_mlp,rel_table", [("float32", 1e-4, 1e-4), ("bfloat16", 2e-3, 1e-1)])
@pytest.mark.parametrize("budget", [0, 150])
def test_fast_loss_gradient_matches_jax(rng, packed_dtype, rel_mlp, rel_table, budget):
    jcfg = dataclasses.replace(JAX_FCFG, packed_dtype=packed_dtype)
    fcfg = _port_fcfg(jcfg)
    jfast = jnsr.FastRenderConfig(n_probes=32, k_samples=8, sample_budget=budget)
    fast = nsr.FastRenderConfig(n_probes=32, k_samples=8, sample_budget=budget)
    jparams = _field()
    grid, o, d, gt = _scene(rng, 40)

    def jloss(p):
        out = jnsr.render_rays_fast(p, o, d, jcfg, jfast, grid, 1.0)
        return jrecon.smooth_l1(out["rgb"], gt) + 0.1 * out["gradient_error"]

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(jparams)
    params = map_leaves(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu"),
                        lambda t: t.requires_grad_())
    loss, _, _ = recon.fast_loss(params, _t(o), _t(d), _t(gt), fcfg, fast, _t(grid), 1.0, 0.1,
                                 nsr.materialize_field_tables(params, fcfg))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5 if packed_dtype == "float32" else 1e-4)
    got_leaves = jax.tree_util.tree_flatten_with_path(map_leaves(params, lambda t: t.grad.numpy()))[0]
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(got_leaves) == len(want_leaves) == 16
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        scale = np.abs(w).max()
        name = jax.tree_util.keystr(path)
        assert scale > 0, name
        rel = rel_table if name.startswith(("['grids']", "['planes']")) else rel_mlp
        np.testing.assert_allclose(g, w, atol=rel * scale, rtol=0, err_msg=name)


def _adam_case(rng):
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()} for _ in range(5)]
    return params, grads


def _torch_steps(opt, sched, tensors, grads):
    out = []
    for g in grads:
        for k, t in tensors.items():
            t.grad = _t(g[k])
        opt.step()
        sched.step()
        out.append({k: t.detach().numpy().copy() for k, t in tensors.items()})
    return out


def test_make_optimizer_matches_optax(rng):
    cfg = recon.ReconstructConfig(lr=5e-3, epochs=1)
    jcfg = jrecon.ReconstructConfig(lr=5e-3, epochs=1)
    params, grads = _adam_case(rng)
    tx = jrecon.make_optimizer(jcfg, 6)  # the cosine reaches 0 after 6 steps
    state, p = tx.init(params), params
    want, states = [], []
    for g in grads:
        up, state = tx.update(g, state, p)
        p = optax.apply_updates(p, up)
        want.append(jax.tree_util.tree_map(np.asarray, p))
        states.append(state)

    tensors = {k: _t(v).requires_grad_() for k, v in params.items()}
    opt, sched = recon.make_optimizer(cfg, 6, list(tensors.values()))
    got = _torch_steps(opt, sched, tensors, grads)
    for w, g in zip(want, got):
        for k in params:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=0)

    # carry optax's state after 3 steps across, then 2 more steps on both
    adam = states[2][0]
    tensors = {k: _t(v).requires_grad_() for k, v in want[2].items()}
    opt, sched = recon.make_optimizer(cfg, 6, list(tensors.values()))
    adam_state_from_optax(opt, tensors, jax.tree_util.tree_map(np.asarray, adam.mu),
                          jax.tree_util.tree_map(np.asarray, adam.nu), int(adam.count), sched)
    got = _torch_steps(opt, sched, tensors, grads[3:])
    for w, g in zip(want[3:], got):
        for k in params:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=0)


def test_cosine_decay_matches_optax():
    sched = optax.cosine_decay_schedule(1.0, decay_steps=7, alpha=0.0)
    factor = recon.cosine_decay(7)
    for step in range(10):
        np.testing.assert_allclose(factor(step), float(sched(step)), rtol=1e-6, atol=1e-7)


def test_update_density_grid_matches_jax():
    R = 17
    old = np.random.default_rng(0).uniform(0, 300, size=(R, R, R)).astype(np.float32)
    want = jax.jit(lambda g: jocc.update_density_grid(
        lambda x: jnp.linalg.norm(x, axis=-1) - 0.8, g, 1.6, block=1))(old)
    got = occ.update_density_grid(lambda x: torch.linalg.norm(x, dim=-1) - 0.8, _t(old), 1.6, block=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRID_ATOL, rtol=0)
    assert (got.numpy() > old * 0.95 - 1e-3).all()  # the EMA-max never drops below decay x old


@pytest.mark.parametrize("R", [17, 33])
def test_make_grid_update_fn_matches_jax(R):
    jparams = _field()
    zeros = np.zeros((R, R, R), np.float32)
    want = np.asarray(jrecon.make_grid_update_fn(JAX_FCFG, 1.6)(jparams, zeros))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    got = recon.make_grid_update_fn(_port_fcfg(JAX_FCFG), 1.6)(params, occ.init_density_grid(R))
    assert got.shape == (R, R, R) and want.max() > 100.0  # a surface crosses the lattice
    np.testing.assert_allclose(got.numpy(), want, atol=GRID_ATOL, rtol=0)


def test_pixel_batches_match_jax():
    a = list(jrecon.pixel_batches(3, 50, 16, np.random.default_rng(5)))
    b = list(recon.pixel_batches(3, 50, 16, np.random.default_rng(5)))
    assert len(a) == len(b) == 9
    for (va, pa), (vb, pb) in zip(a, b):
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(pa, pb)
        assert va.dtype == vb.dtype and pa.dtype == pb.dtype


def test_ray_fn_and_smooth_l1_match_jax(rng):
    K = np.array([[20.0, 0, 8.0], [0, 21.0, 7.5], [0, 0, 1]], np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * 3)
    poses[:, :3, :3] = np.linalg.qr(rng.normal(size=(3, 3, 3)))[0].astype(np.float32)
    poses[:, :3, 3] = rng.normal(size=(3, 3)).astype(np.float32)
    vi = rng.integers(0, 3, 40).astype(np.int32)
    pi = rng.integers(0, 16 * 16, 40).astype(np.int32)
    want = jax.jit(jrecon.make_batch_ray_fn(K, 16, 16))(poses, vi, pi)
    got = recon.make_batch_ray_fn(K, 16, 16)(_t(poses), _t(vi).long(), _t(pi).long())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    a, b = rng.normal(size=(32, 3)).astype(np.float32) * 2, rng.normal(size=(32, 3)).astype(np.float32)
    np.testing.assert_allclose(float(recon.smooth_l1(_t(a), _t(b))), float(jrecon.smooth_l1(a, b)), rtol=1e-6)
    np.testing.assert_allclose(float(recon.smooth_l1(_t(a), _t(b))),
                               float(torch.nn.functional.smooth_l1_loss(_t(a), _t(b))), rtol=1e-6)


def test_init_field_params_tree_and_deterministic_parts():
    fcfg = _port_fcfg(JAX_FCFG)
    want = jnsr.init_field_params(jax.random.PRNGKey(0), JAX_FCFG)
    got = nsr.init_field_params(torch.Generator().manual_seed(0), fcfg)
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    gl = jax.tree_util.tree_flatten_with_path(map_leaves(got, lambda t: t.numpy()))[0]
    assert [jax.tree_util.keystr(p) for p, _ in gl] == [jax.tree_util.keystr(p) for p, _ in wl]
    for (_, g), (_, w) in zip(gl, wl):
        assert g.shape == w.shape and g.dtype == np.asarray(w).dtype
    again = nsr.init_field_params(torch.Generator().manual_seed(0), fcfg)
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(again)))  # one seed, one tree

    first, last = got["sdf"][0], got["sdf"][-1]
    assert torch.equal(first["v"][:, 3:], torch.zeros_like(first["v"][:, 3:]))  # encoding block zero
    assert first["v"][:, :3].std() == pytest.approx(np.sqrt(2.0 / 64), rel=0.15)
    assert last["v"].mean() == pytest.approx(np.sqrt(np.pi) / np.sqrt(64), abs=1e-4)
    assert last["v"].std() == pytest.approx(1e-4, rel=0.2)
    for layer in got["sdf"]:
        assert torch.equal(layer["b"], torch.zeros_like(layer["b"]))
        torch.testing.assert_close(layer["g"], torch.linalg.norm(layer["v"], dim=1).clamp_min(1e-8))
    for layer in got["color"]:
        bound = 1.0 / np.sqrt(layer["v"].shape[1])
        assert layer["v"].abs().max() <= bound and layer["v"].abs().max() > 0.8 * bound
        torch.testing.assert_close(layer["g"], torch.linalg.norm(layer["v"], dim=1))
    assert float(got["variance"]) == pytest.approx(0.3)
    for t in got["grids"] + got["planes"]:
        assert t.abs().max() <= 1e-4 and t.abs().max() > 0.9e-4


def _image_set():
    """tests/test_reconstruct.py's tiny dataset, in memory: 2 views of a
    white disc on black, 16x16, cameras at distance 2."""
    poses, images = [], []
    for angle in (0.0, np.pi / 2):
        c, s = np.cos(angle), np.sin(angle)
        poses.append(np.array([[c, 0, s, 2 * s], [0, 1, 0, 0], [-s, 0, c, 2 * c], [0, 0, 0, 1]], np.float32))
        img = np.zeros((16, 16, 3), np.float32)
        yy, xx = np.mgrid[:16, :16]
        img[(yy - 8) ** 2 + (xx - 8) ** 2 < 25] = 1.0
        images.append(img[:, ::-1])
    focal = 0.5 * 16 / np.tan(0.5 * 1.0471975511965976)
    K = np.array([[focal, 0, 8.0], [0, focal, 8.0], [0, 0, 1]], np.float32)
    images = np.stack(images)
    return recon.ImageSet(K=K, poses=np.stack(poses), images=images, masks=(images != 0).any(-1).astype(np.float32))


def test_train_fast_three_steps_match_jax(monkeypatch):
    tiny = dataclasses.replace(
        JAX_FCFG, pyramid=JaxPyramidSpec(grid_resolutions=(8, 16), grid_dim=2, plane_resolutions=(33,), plane_dim=2)
    )
    jfast = jnsr.FastRenderConfig(n_probes=32, k_samples=12, bound=1.6)
    fast = nsr.FastRenderConfig(n_probes=32, k_samples=12, bound=1.6)
    ds = _image_set()
    kw = dict(max_steps=3, grid_update_every=2, grid_warmup_steps=1, grid_resolution=17, log_every=1)

    monkeypatch.setattr(jrecon, "make_optimizer", lambda cfg, spe: optax.sgd(5e-2))
    jcfg = jrecon.ReconstructConfig(batch_size=64, epochs=2, white_bkg=False, bkg_mode="composite_random")
    jparams, jgrid, jstats = jrecon.train_fast(ds, tiny, jfast, jcfg, **kw)

    init = jnsr.init_field_params(jax.random.PRNGKey(jcfg.seed), tiny)
    monkeypatch.setattr(recon, "init_field_params",
                        lambda gen, fcfg: params_from_jax(jax.tree_util.tree_map(np.asarray, init), device="cpu"))
    monkeypatch.setattr(recon, "make_optimizer", lambda cfg, spe, ps: (torch.optim.SGD(ps, lr=5e-2), None))
    cfg = recon.ReconstructConfig(batch_size=64, epochs=2, white_bkg=False, bkg_mode="composite_random")
    params, grid, stats = recon.train_fast(ds, _port_fcfg(tiny), fast, cfg, device="cpu", **kw)

    assert [s for s, _ in stats["losses"]] == [s for s, _ in jstats["losses"]] == [0, 1, 2]
    np.testing.assert_allclose([l for _, l in stats["losses"]], [l for _, l in jstats["losses"]], rtol=1e-4)
    assert stats["steps"] == 3 and stats["steps_per_sec"] > 0
    # the refresh from zeros after step 2 replaced the saturated grid
    assert float(grid.max()) < 100.0 and torch.isfinite(grid).all() and grid.shape == (17, 17, 17)
    np.testing.assert_allclose(grid.numpy(), np.asarray(jgrid), atol=GRID_ATOL, rtol=0)


def test_train_fast_refresh_schedule_matches_jax(monkeypatch):
    """chip_smoke.py's train schedule (40 steps, the refresh from zeros at
    step 20, an EMA refresh at 40) with ReconstructConfig's own Adam, the
    JAX trainer and the port's from one initial field. init_field_params'
    SDF is positive everywhere, so at step 20 the young field has no
    surface yet: in both trainers the refresh from zeros leaves a near-empty
    grid and the loss rises after it, and the mean loss of the last 5 steps
    ends above that of the first 5."""
    tiny = dataclasses.replace(
        JAX_FCFG, pyramid=JaxPyramidSpec(grid_resolutions=(8, 16), grid_dim=2, plane_resolutions=(33,), plane_dim=2)
    )
    kw = dict(max_steps=40, grid_update_every=20, grid_warmup_steps=20, grid_resolution=17, log_every=1)
    cfg = dict(batch_size=64, epochs=5, white_bkg=False, bkg_mode="composite")
    ds = _image_set()
    jcfg = jrecon.ReconstructConfig(**cfg)
    _, jgrid, jstats = jrecon.train_fast(ds, tiny, jnsr.FastRenderConfig(n_probes=32, k_samples=12, bound=1.6), jcfg, **kw)

    init = jnsr.init_field_params(jax.random.PRNGKey(jcfg.seed), tiny)
    monkeypatch.setattr(recon, "init_field_params",
                        lambda gen, fcfg: params_from_jax(jax.tree_util.tree_map(np.asarray, init), device="cpu"))
    _, grid, stats = recon.train_fast(ds, _port_fcfg(tiny), nsr.FastRenderConfig(n_probes=32, k_samples=12, bound=1.6),
                                      recon.ReconstructConfig(**cfg), device="cpu", **kw)

    want = np.asarray([l for _, l in jstats["losses"]])
    got = np.asarray([l for _, l in stats["losses"]])
    assert len(got) == len(want) == 40
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(grid.numpy(), np.asarray(jgrid), atol=GRID_ATOL, rtol=0)
    means = {span: float(want[span[0] : span[1]].mean()) for span in ((0, 5), (15, 20), (20, 25), (35, 40))}
    print(f"JAX train_fast: mean loss of steps {means}; grid max after the refresh at 40 {float(np.max(jgrid)):.3g}")
    for g, losses in ((np.asarray(jgrid), want), (grid.numpy(), got)):
        assert g.max() < 1e-3  # no lattice point near a surface
        assert losses[20:25].mean() > losses[15:20].mean()  # the loss rises after the refresh
        assert losses[35:].mean() > losses[:5].mean()


def test_make_train_step_matches_jax(rng):
    """One importance-sampled step (64+64 samples cut to 6+6, fd7) under
    SGD: the loss 1e-5 relative and every updated leaf 3e-5 absolute, the
    pins of tests/test_table_mp.py's step."""
    jparams = _field()
    K = np.array([[20.0, 0, 8.0], [0, 20.0, 8.0], [0, 0, 1]], np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * 2)
    poses[:, 2, 3] = 2.6
    vi = rng.integers(0, 2, 32).astype(np.int32)
    pi = rng.integers(0, 256, 32).astype(np.int32)
    gt = rng.random((32, 3)).astype(np.float32)
    jrcfg = jnsr.RenderConfig(num_steps=6, upsample_steps=6, upsample_round=3)
    tx = optax.sgd(0.5)
    jstep = jrecon.make_train_step(JAX_FCFG, jrcfg, tx, jrecon.make_batch_ray_fn(K, 16, 16), 0.1, 1.0)
    want, _, jloss, _ = jstep(jparams, tx.init(jparams), poses, vi, pi, gt, jax.random.PRNGKey(0))

    rcfg = nsr.RenderConfig(num_steps=6, upsample_steps=6, upsample_round=3)
    params = map_leaves(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu"),
                        lambda t: t.requires_grad_())
    opt = torch.optim.SGD(leaves(params), lr=0.5)
    step = recon.make_train_step(_port_fcfg(JAX_FCFG), rcfg, opt, recon.make_batch_ray_fn(K, 16, 16), 0.1, 1.0)
    loss, _ = step(params, _t(poses), _t(vi).long(), _t(pi).long(), _t(gt))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = jax.tree_util.tree_flatten_with_path(map_leaves(params, lambda t: t.detach().numpy()))[0]
    for (path, g), (_, w) in zip(got, jax.tree_util.tree_flatten_with_path(want)[0]):
        np.testing.assert_allclose(g, np.asarray(w), atol=3e-5, rtol=0, err_msg=jax.tree_util.keystr(path))
