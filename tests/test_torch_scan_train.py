"""Several train steps per call (``train_fast(scan_steps=S)``, the JAX
package's ``lax.scan`` branch; on the card a CUDA graph of the step) in the
PyTorch port against the JAX package, on the CPU, where the port runs the
same step eagerly: the 16x16 disc set of tests/test_torch_reconstruct_cli.py
at its TINY_PYR widths, S = 4.

Tolerances:
* the port's scan against JAX's scan, ReconstructConfig's own Adam from
  one initial field, 10 steps (two calls and a partial tail): the logged
  (step, loss) pairs, one a call, at 1e-4 relative and the refreshed grids
  at 512^2/4 x 1e-6, as tests/test_torch_reconstruct_cli.py holds
  train_fast; every parameter within 2 lr x 10 steps (where a gradient is
  near 0 Adam's normalised step takes either sign on either side: the
  bound of a parameter that moved the other way at every step), all but
  1% of the values within 1e-5;
* the port's scan against its own per-step branch on the same batches
  (raw and composite backgrounds): bitwise, losses, parameters and grid;
  the CPU's Adam takes each learning rate in double in both;
* ``composite_random``: the index blocks, epoch 2 included, exactly the
  JAX scan branch's (the numpy generator draws nothing per step), one
  background a step from the torch generator;
* a resume from the JAX package's scan train state (carried with
  train_state_from_optax): losses 1e-4 relative, the grid 512^2/4 x 1e-6.

The JAX scan branch passes ``on_step`` the step count after a call, where
its per-step branch passes the step's index, and reconstruct_cli's
callbacks test ``(step + 1) % i_val``: under ``--scan_steps`` the JAX
CLI's validation renders, checkpoints and meshes fire only where a call
ends one step before a multiple of their period. The port keeps the JAX
scan branch's argument (a fault of the reference, ROADMAP queue 3). JAX's
scan branch times its rates from step 0 (its ``timed_from`` is set in a
nested function and lost); the port times them from the end of the first
call, as the docstring of both says.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatarcraft_tpu.data import SMPLMultiviewDataset as JaxDataset
from avatarcraft_tpu.models import instant_nsr as jnsr
from avatarcraft_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from avatarcraft_tpu.workloads import reconstruct as jrecon
from avatarcraft_tpu_torch.data import SMPLMultiviewDataset
from avatarcraft_tpu_torch.models import instant_nsr as nsr
from avatarcraft_tpu_torch.utils.checkpoint import leaves, load_train_state, params_from_jax, train_state_from_optax
from avatarcraft_tpu_torch.workloads import reconstruct as recon
from test_torch_reconstruct_cli import GRID_ATOL, TINY_PYR, TINY_PYR_JAX, _jax_init, disc_set  # noqa: F401

S, MAX_STEPS = 4, 10
FAST_KW = dict(grid_update_every=4, grid_warmup_steps=4, grid_resolution=17, log_every=1)
CFG_KW = dict(batch_size=64, epochs=2, white_bkg=False, bkg_mode="raw")
FAST = dict(n_probes=32, k_samples=12, bound=1.6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work (tier-1 runs six
    pytest workers on the machine's cores). Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_init():
    return _jax_init(TINY_PYR_JAX)


@pytest.fixture
def port_init(monkeypatch, jax_init):
    """The port's trainers start from the JAX package's initial field."""
    monkeypatch.setattr(recon, "init_field_params", lambda gen, fcfg: params_from_jax(jax_init, device="cpu"))


def _recorder(seen: list):
    def on_step(step, params, loss, grid):
        seen.append((step, float(loss), float(np.asarray(grid).max())))

    return {"on_step": on_step}


@pytest.fixture(scope="module")
def jax_scan_runs(disc_set, tmp_path_factory):  # noqa: F811
    """JAX's scan branch for MAX_STEPS steps saving its state every 4 (the
    state at step 8 stays), then resumed from that state to step 12."""
    root = str(tmp_path_factory.mktemp("jax_scan"))
    ds, cfg = JaxDataset(disc_set), jrecon.ReconstructConfig(**CFG_KW)
    fast = jnsr.FastRenderConfig(**FAST)
    seen = []
    params, grid, stats = jrecon.train_fast(ds, TINY_PYR_JAX, fast, cfg, max_steps=MAX_STEPS, scan_steps=S,
                                            state_dir=root, save_state_every=4, callbacks=_recorder(seen), **FAST_KW)
    resumed = jrecon.train_fast(ds, TINY_PYR_JAX, fast, cfg, max_steps=12, scan_steps=S,
                                resume_from=f"{root}/state_latest", **FAST_KW)
    return {"params": params, "grid": grid, "stats": stats, "seen": seen, "root": root, "resumed": resumed}


def test_scan_matches_jax(disc_set, jax_scan_runs, port_init, tmp_path, jax_init):  # noqa: F811
    """Calls of 4, 4 and 2 steps; the grid refreshed after the calls that
    end at steps 4 (from zeros) and 8 (EMA); the state saved at step 8."""
    seen = []
    params, grid, stats = recon.train_fast(
        SMPLMultiviewDataset(disc_set), TINY_PYR, nsr.FastRenderConfig(**FAST), recon.ReconstructConfig(**CFG_KW),
        max_steps=MAX_STEPS, scan_steps=S, state_dir=str(tmp_path), save_state_every=4,
        callbacks=_recorder(seen), device="cpu", **FAST_KW)
    want = jax_scan_runs["stats"]
    assert [s for s, _ in stats["losses"]] == [s for s, _ in want["losses"]] == [4, 8, 10]
    np.testing.assert_allclose([l for _, l in stats["losses"]], [l for _, l in want["losses"]], rtol=1e-4)
    assert stats["steps"] == want["steps"] == MAX_STEPS and stats["steps_per_sec"] > 0
    np.testing.assert_allclose(grid.numpy(), np.asarray(jax_scan_runs["grid"]), atol=GRID_ATOL, rtol=0)
    # the callbacks at the same step counts, the refreshes after the same calls
    jseen = jax_scan_runs["seen"]
    assert [s for s, _, _ in seen] == [s for s, _, _ in jseen] == [4, 8, 10]
    assert [m < 100.0 for _, _, m in seen] == [m < 100.0 for _, _, m in jseen] == [True, True, True]
    np.testing.assert_allclose([m for _, _, m in seen], [m for _, _, m in jseen], atol=GRID_ATOL, rtol=0)
    # the state saved at step 8 by both
    mine = load_train_state(str(tmp_path / "state_latest"), "cpu")
    assert mine["step"] == 8 and mine["count"] == 8
    assert sorted(os.listdir(tmp_path)) == ["state_final", "state_latest"]  # orbax directories
    like = {"params": jax_init, "opt_state": jrecon.make_optimizer(jrecon.ReconstructConfig(**CFG_KW), 16).init(jax_init),
            "grid": np.zeros((17,) * 3, np.float32), "step": 0}
    assert int(jax_load_checkpoint(f"{jax_scan_runs['root']}/state_latest", like)["step"]) == 8
    assert int(jax_load_checkpoint(str(tmp_path / "state_latest"), like)["step"]) == 8
    # the parameters
    got = [t.numpy() for t in leaves(params)]
    ref = [np.asarray(a) for a in jax.tree_util.tree_leaves(jax_scan_runs["params"])]
    assert [g.shape for g in got] == [r.shape for r in ref]
    diff = np.concatenate([np.abs(g - r).reshape(-1) for g, r in zip(got, ref)])
    assert diff.max() <= 2 * 5e-4 * MAX_STEPS
    assert np.mean(diff > 1e-5) <= 0.01


@pytest.mark.parametrize("bkg_mode", ["raw", "composite"])
def test_scan_equals_the_per_step_branch(disc_set, bkg_mode):  # noqa: F811
    """One field, the same batches: the scan's steps are the per-step
    branch's, bit for bit (the CPU runs the scan's step eagerly)."""
    ds, fast = SMPLMultiviewDataset(disc_set), nsr.FastRenderConfig(**FAST)
    cfg = recon.ReconstructConfig(**dict(CFG_KW, bkg_mode=bkg_mode))
    kw = dict(max_steps=MAX_STEPS, device="cpu", **FAST_KW)
    p0, g0, s0 = recon.train_fast(ds, TINY_PYR, fast, cfg, **kw)
    p1, g1, s1 = recon.train_fast(ds, TINY_PYR, fast, cfg, scan_steps=S, **kw)
    per_step = dict(s0["losses"])
    assert [(s, l) for s, l in s1["losses"]] == [(s, per_step[s - 1]) for s in (4, 8, 10)]
    assert all(torch.equal(a, b) for a, b in zip(leaves(p0), leaves(p1)))
    assert torch.equal(g0, g1)


def test_composite_random_streams(disc_set, monkeypatch):  # noqa: F811
    """composite_random over two epochs (16 steps an epoch): the port's
    index blocks are the JAX scan branch's, epoch 2 included, so the numpy
    generator draws nothing per step (JAX's per-step branch draws one
    rng.uniform() a step, which moves epoch 2's permutation); one gray
    level a step comes from the torch generator. JAX's train step is
    replaced by a stand-in that records its index blocks (the loop is what
    is compared; its step compiles for a minute)."""
    steps = 24
    cfg_kw = dict(CFG_KW, bkg_mode="composite_random")
    kw = dict(max_steps=steps, grid_update_every=0, grid_resolution=17, log_every=1)

    jax_blocks = []

    def fake_scan(*args, **kwargs):
        def scan_fn(params, opt_state, poses, images_flat, masks_flat, vis, pis, grid, key):
            jax_blocks.append((np.asarray(vis), np.asarray(pis)))
            return params, opt_state, jnp.zeros(vis.shape[0])

        return scan_fn

    monkeypatch.setattr(jrecon, "make_train_scan_fast", fake_scan)
    jrecon.train_fast(JaxDataset(disc_set), TINY_PYR_JAX, jnsr.FastRenderConfig(**FAST),
                      jrecon.ReconstructConfig(**cfg_kw), scan_steps=S, **kw)

    port_blocks, drawn = [], []
    real_scan, real_draw = recon.make_train_scan_fast, recon.draw_backgrounds

    def recording_scan(*args, **kwargs):
        scan = real_scan(*args, **kwargs)

        def call(rest, shards, poses, images_flat, masks_flat, vis, pis, *rest_args):
            port_blocks.append((np.asarray(vis), np.asarray(pis)))
            return scan(rest, shards, poses, images_flat, masks_flat, vis, pis, *rest_args)

        return call

    def counting_draw(generator, n, device):
        drawn.append(n)
        return real_draw(generator, n, device)

    monkeypatch.setattr(recon, "make_train_scan_fast", recording_scan)
    monkeypatch.setattr(recon, "draw_backgrounds", counting_draw)
    _, _, stats = recon.train_fast(SMPLMultiviewDataset(disc_set), TINY_PYR, nsr.FastRenderConfig(**FAST),
                                   recon.ReconstructConfig(**cfg_kw), scan_steps=S, device="cpu", **kw)
    assert stats["steps"] == steps and drawn == [S] * (steps // S)
    assert len(port_blocks) == len(jax_blocks) == steps // S
    for (pv, pp), (jv, jp) in zip(port_blocks, jax_blocks):
        np.testing.assert_array_equal(pv, jv)
        np.testing.assert_array_equal(pp, jp)
    # epoch 2 (steps 16-23) is a fresh generator's second permutation
    rng = np.random.default_rng(cfg_kw.get("seed", 42))
    epochs = [list(recon.pixel_batches(4, 256, 64, rng)) for _ in range(2)]
    want = np.stack([v for v, _ in epochs[1][:8]]), np.stack([p for _, p in epochs[1][:8]])
    np.testing.assert_array_equal(np.concatenate([v for v, _ in port_blocks[4:]]), want[0])
    np.testing.assert_array_equal(np.concatenate([p for _, p in port_blocks[4:]]), want[1])


def test_resume_from_jax_scan_state(disc_set, jax_scan_runs, port_init, jax_init, tmp_path):  # noqa: F811
    """JAX's scan train state at step 8, carried across, resumed in the
    port's scan branch to step 12: the JAX resume's losses and grid."""
    cfg = jrecon.ReconstructConfig(**CFG_KW)
    like = {"params": jax_init, "opt_state": jrecon.make_optimizer(cfg, 16).init(jax_init),
            "grid": np.zeros((17,) * 3, np.float32), "step": 0}
    state = jax_load_checkpoint(f"{jax_scan_runs['root']}/state_latest", like)
    adam = state["opt_state"][0]
    carried = str(tmp_path / "carried.pt")
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    train_state_from_optax(carried, as_np(state["params"]), as_np(adam.mu), as_np(adam.nu), int(adam.count),
                           int(state["step"]), np.asarray(state["grid"]))
    _, grid, stats = recon.train_fast(
        SMPLMultiviewDataset(disc_set), TINY_PYR, nsr.FastRenderConfig(**FAST), recon.ReconstructConfig(**CFG_KW),
        max_steps=12, scan_steps=S, resume_from=carried, device="cpu", **FAST_KW)
    _, jgrid, jstats = jax_scan_runs["resumed"]
    assert [s for s, _ in stats["losses"]] == [s for s, _ in jstats["losses"]] == [12]
    np.testing.assert_allclose([l for _, l in stats["losses"]], [l for _, l in jstats["losses"]], rtol=1e-4)
    np.testing.assert_allclose(grid.numpy(), np.asarray(jgrid), atol=GRID_ATOL, rtol=0)


def test_scan_refuses_other_tensors():
    """A scan runs on the tensors of its first call (on the card a CUDA
    graph holds them): a call with another grid raises, as does a call of
    more steps than the first."""
    params = nsr.init_field_params(torch.Generator().manual_seed(0), TINY_PYR)
    from avatarcraft_tpu_torch.parallel.table_mp import trainable_shards

    rest, shards, splice = trainable_shards(params)
    opt, sched = recon.make_optimizer(recon.ReconstructConfig(), 10, leaves(rest) + shards)
    K = np.array([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]], np.float32)
    scan = recon.make_train_scan_fast(TINY_PYR, nsr.FastRenderConfig(**FAST), opt, recon.make_batch_ray_fn(K, 16, 16),
                                      0.1, "raw", False, splice)
    poses = torch.eye(4)[None].repeat(2, 1, 1)
    poses[:, 2, 3] = 2.0
    images, masks, grid = torch.rand(2, 256, 3), torch.zeros(1, 1), torch.full((17,) * 3, 100.0)
    vis, pis = np.zeros((2, 8), np.int32), np.arange(16, dtype=np.int32).reshape(2, 8)
    losses = scan(rest, shards, poses, images, masks, vis, pis, sched.advance(2), grid)
    assert losses.shape == (2,) and torch.isfinite(losses).all()
    with pytest.raises(ValueError, match="tensors of its first call"):
        scan(rest, shards, poses, images, masks, vis, pis, sched.advance(2), grid.clone())
    with pytest.raises(ValueError, match="at most 2"):
        scan(rest, shards, poses, images, masks, np.zeros((3, 8), np.int32), np.zeros((3, 8), np.int32),
             sched.advance(3), grid)


def test_cli_scan_steps(disc_set, tmp_path, monkeypatch):  # noqa: F811
    """reconstruct_cli --sampler fast --scan_steps 2 runs (it was refused
    before the scan was ported): 5 steps as calls of 2, 2 and 1, the
    state saved at step 4, the CLI's files; --scan_steps keeps the JAX
    CLI's default and help."""
    from avatarcraft_tpu.cli import reconstruct_cli as jcli
    from avatarcraft_tpu_torch.cli import reconstruct_cli
    from test_torch_reconstruct_cli import _small_field_config

    _small_field_config(monkeypatch)
    out = tmp_path / "out"
    params, stats = reconstruct_cli.main([
        "--data_path", disc_set, "--use_cuda", "false", "--out_dir", str(out), "--exp_name", "s", "--sampler", "fast",
        "--batch_size", "64", "--max_steps", "5", "--scan_steps", "2", "--save_state_every", "4",
        "--grid_warmup_steps", "2", "--mesh_resolution", "16"])
    assert stats["steps"] == 5 and [s for s, _ in stats["losses"]] == [2, 4, 5]
    assert all(np.isfinite(l) for _, l in stats["losses"])
    assert load_train_state(str(out / "s" / "state_latest"), "cpu")["step"] == 4
    assert {"s_final.pth.tar", "s_grid.npy", "state_final"} <= set(os.listdir(out / "s"))

    def scan_flag(parser):
        return next((a.default, a.help) for a in parser._actions if a.dest == "scan_steps")

    assert scan_flag(reconstruct_cli.build_parser()) == scan_flag(jcli.build_parser())
