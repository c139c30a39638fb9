"""The port's fine-tune and demo-body tools (``avatarcraft_tpu_torch/tools/``:
finetune_color, finetune_ss, make_demo_body) against the JAX package's root
``tools/``, on the CPU, at small sizes: tests/test_torch_tools.py's 16x16
disc set of 4 views and its pyramid field with f32 tables (a surface, a
129^3 grid in the train state, a 17^3 grid beside the checkpoint). Each JAX
tool's ``main`` runs once, in the module fixture ``jax_runs``, with its
step or scan wrapped to record the losses and batches; the port's tools run
with ``--platform cpu``.

Tolerances:
* finetune_color (3 steps, batch 64, analytic normals, from the JAX orbax
  state): every frozen leaf (SDF MLP, tables, variance), the grid and the
  input state's Adam moments bitwise the input's, the count and step
  exact; the losses at 1e-4 relative (tests/test_torch_train.py's bound
  for f32 sums in other orders); the color leaves within 1e-5 relative
  plus 1e-4 x lr per step of JAX's (Adam against optax: the bias
  corrections in double against f32, tests/test_torch_guidance.py's
  bound);
* finetune_ss (ss 2, 3 calls of 2 steps, batch 32 with a quarter from the
  silhouette band, one refresh, one save): the [S, B] view and pixel blocks
  of every call bitwise JAX's (the numpy generator and the band lists),
  the band's printed mean length and share JAX's; the
  losses at 1e-4 relative and the JSON's final loss at 1e-4 relative, the
  refreshed 17^3 grid at 512^2/4 x 1e-6 (tests/test_torch_train.py's
  refresh bound); the saved steps and counts exact;
* make_demo_body (both rigs at 16^3): the .npz's keys, dtypes and shapes
  exactly, the faces and parents equal, every float array within 1e-5
  absolute (the SDF lattices differ in their last bits: f32 sums in other
  orders, tests/test_torch_reconstruct_cli.py's lattice bound, carried
  through the interpolation of the vertices and the rig's sigmoids), the
  articulated rig's joint regressor also within 1e-4 relative (its
  Gaussian weights amplify a vertex's shift; NaN rows, where no vertex
  lies near an anchor of this small field, NaN in both); the port's
  load_smpl and render_warp_cli read it.
"""

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from avatarcraft_tpu.models import instant_nsr as jnsr
from avatarcraft_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from avatarcraft_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from avatarcraft_tpu.workloads import reconstruct as jrecon
from avatarcraft_tpu_torch.cli import render_warp_cli
from avatarcraft_tpu_torch.models.smpl import load_smpl
from avatarcraft_tpu_torch.tools import bake_artifact, eval_psnr, finetune_color, finetune_ss, make_demo_body
from avatarcraft_tpu_torch.data import SMPLMultiviewDataset
from avatarcraft_tpu_torch.utils.checkpoint import (
    load_params_with_config,
    load_train_state,
    sorted_leaf_paths,
    sorted_leaves,
    train_state_from_optax,
)
from avatarcraft_tpu_torch.workloads import reconstruct as recon
from test_torch_tools import (
    JAX_FCFG,
    _disc_set,
    _drawn,
    _field,
    _last_json,
    _np_tree,
    _run_jax,
    _save_field,
    _small_field_config,
)
from tools import finetune_color as jfinetune_color
from tools import finetune_ss as jfinetune_ss
from tools import make_demo_body as jmake_demo_body

LOSS_RTOL = 1e-4
GRID_ATOL = 512.0**2 / 4 * 1e-6
ADAM_RTOL, ADAM_LR_ATOL = 1e-5, 1e-4  # tests/test_torch_guidance.py's Adam against optax
BODY_ATOL = 1e-5
# the articulated regressor exp(-d^2 / (0.02 H)^2), normalised: a vertex
# moved by e moves an entry by up to 2 d e / (0.02 H)^2 of itself (5e-5
# here at e = 1e-6)
REGRESSOR_RTOL = 1e-4
STATE_STEP = 7
COLOR_ARGV = ["--steps", "3", "--batch", "64", "--lr", "5e-3"]
COLOR_LR, COLOR_STEPS = 5e-3, 3
SS_ARGV = ["--ss", "2", "--steps", "6", "--scan", "2", "--batch", "32", "--grid_refresh", "4", "--edge_frac", "0.25",
           "--edge_band", "1", "--save_every", "4", "--lr", "1e-3"]
SS_CALLS = 3
BODY_ARGV = {"root": ["--resolution", "16", "--rig", "root"], "articulated": ["--resolution", "16", "--rig",
                                                                               "articulated"]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work (tier-1 runs six
    pytest workers on the machine's cores). Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The disc set; the field as a checkpoint with a 17^3 grid, as a JAX
    orbax train state (a 129^3 grid, optax Adam's state after two updates)
    and as the port's state file of the same state."""
    root = tmp_path_factory.mktemp("finetune")
    f = {"root": str(root), "data": str(root / "disc")}
    _disc_set(f["data"])
    rng = np.random.default_rng(5)
    jfield = _field(JAX_FCFG, 0)
    f["jfield"] = jfield
    f["ckpt"], f["grid17"] = str(root / "field.pth.tar"), str(root / "grid17.npy")
    _save_field(jfield, f["ckpt"])
    np.save(f["grid17"], np.where(rng.random((17,) * 3) < 0.6, 50.0, 0.5).astype(np.float32))
    opt_state = jrecon.make_optimizer(jrecon.ReconstructConfig(), 1000).init(jfield)
    adam = opt_state[0]._replace(mu=_drawn(jfield, rng, 1e-3),
                                 nu=jax.tree_util.tree_map(np.square, _drawn(jfield, rng, 1e-3)),
                                 count=np.asarray(2, np.int32))
    opt_state = (adam,) + tuple(opt_state[1:])
    f["grid129"] = np.where(rng.random((129,) * 3) < 0.6, 50.0, 0.5).astype(np.float32)
    f["orbax"] = str(root / "state_orbax")
    jax_save_checkpoint(f["orbax"], {"params": jfield, "opt_state": _np_tree(opt_state), "grid": f["grid129"],
                                     "step": STATE_STEP})
    f["pt"] = str(root / "state.pt")
    train_state_from_optax(f["pt"], jfield, adam.mu, adam.nu, int(adam.count), STATE_STEP, f["grid129"])
    return f


@contextlib.contextmanager
def _recorded(module, name: str, record: list, index):
    """``module.<name>`` (a step or scan factory) wrapped so that every call
    of what it makes appends ``index(args, result)`` to ``record``."""
    real = getattr(module, name)

    def factory(*a, **kw):
        fn = real(*a, **kw)

        def wrapped(*args):
            out = fn(*args)
            record.append(index(args, out))
            return out

        return wrapped

    setattr(module, name, factory)
    try:
        yield
    finally:
        setattr(module, name, real)


@pytest.fixture(scope="module")
def jax_runs(inputs):
    """Each JAX tool's main once: finetune_color from the orbax state (its
    step's losses recorded), finetune_ss from the checkpoint and its 17^3
    grid (each call's index blocks and losses recorded, its JSON line),
    make_demo_body for both rigs."""
    f, root = inputs, inputs["root"]
    runs = {"color_losses": [], "ss_calls": []}
    with pytest.MonkeyPatch.context() as m:
        _small_field_config(m, jax_side=True)
        m.setattr(jnsr, "init_field_params", lambda key, jcfg: _field(jcfg, 0))
        with _recorded(jrecon, "make_train_step_fast", runs["color_losses"], lambda a, out: float(out[2])):
            _run_jax(jfinetune_color.main, ["--state", f["orbax"], "--out", os.path.join(root, "jax_color"),
                                            "--data_path", f["data"]] + COLOR_ARGV)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            runs["ss"] = _last_json(_run_jax(
                lambda argv: _with_recorded_scan(runs["ss_calls"], argv),
                ["--ckpt", f["ckpt"], "--grid_path", f["grid17"], "--out", os.path.join(root, "jax_ss"),
                 "--data_path", f["data"]] + SS_ARGV))
        runs["ss_band"] = _band_line(err.getvalue())
    for rig, argv in BODY_ARGV.items():
        _run_jax(jmake_demo_body.main, ["--ckpt", f["ckpt"], "--out", os.path.join(root, f"jax_{rig}.npz"),
                                        "--platform", "cpu"] + argv)
    return runs


def _band_line(stderr: str) -> str:
    """The silhouette band's line of a finetune_ss run."""
    (line,) = [l for l in stderr.splitlines() if l.startswith("silhouette band:")]
    return line


def _with_recorded_scan(calls: list, argv):
    index = lambda a, out: (np.asarray(a[5]), np.asarray(a[6]), np.asarray(out[2]))  # noqa: E731
    with _recorded(jrecon, "make_train_scan_fast", calls, index):
        jfinetune_ss.main(argv)


def _leaves_by_path(tree) -> dict:
    return dict(zip(sorted_leaf_paths(tree), (t.numpy() for t in sorted_leaves(tree))))


# ---------------------------------------------------------------------------
# finetune_color
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["orbax", "pt"])
def test_finetune_color_matches_jax(inputs, jax_runs, source, monkeypatch, tmp_path, capsys):
    """From the JAX orbax state and the port's state file of it: the frozen
    leaves, the grid and the input state's Adam moments bitwise the input's,
    the count and step (7 + 3) exact; the color leaves and the losses
    against JAX's run of the same flags (read back from its orbax output).
    The output is an orbax directory from the orbax state (JAX restores it
    with its tool's target: the input's optax state bitwise, as its own
    output holds it) and a port file from the port's."""
    f = inputs
    _small_field_config(monkeypatch, jax_side=False)
    out = str(tmp_path / ("color" if source == "orbax" else "color.pt"))
    got = finetune_color.main(["--state", f[source], "--out", out, "--data_path", f["data"], "--platform", "cpu"]
                              + COLOR_ARGV)
    assert _last_json(capsys.readouterr().out) == json.loads(json.dumps(got))
    assert got["step"] == STATE_STEP + COLOR_STEPS and got["normal_mode"] == "analytic"
    np.testing.assert_allclose(got["losses"], jax_runs["color_losses"], rtol=LOSS_RTOL)

    mine, start = load_train_state(out, "cpu"), load_train_state(f[source], "cpu")
    want = load_train_state(os.path.join(f["root"], "jax_color"), "cpu")
    assert mine["step"] == want["step"] == STATE_STEP + COLOR_STEPS and mine["count"] == want["count"] == 2
    assert torch.equal(mine["grid"], start["grid"])
    a, b, w = _leaves_by_path(mine["params"]), _leaves_by_path(start["params"]), _leaves_by_path(want["params"])
    assert a.keys() == b.keys() == w.keys()
    for k in a:
        if k.startswith("['color']"):
            assert not np.array_equal(a[k], b[k]), k  # trained
            np.testing.assert_allclose(a[k], w[k], rtol=ADAM_RTOL, atol=ADAM_LR_ATOL * COLOR_LR * COLOR_STEPS,
                                       err_msg=k)
        else:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k  # frozen: bitwise
            assert np.array_equal(w[k], b[k]), k
    for key in ("mu", "nu"):  # the original moments, as JAX keeps them
        for x, y in zip(sorted_leaves(mine[key]), sorted_leaves(start[key])):
            assert torch.equal(x, y)
    assert os.path.isdir(out) == (source == "orbax")
    if source == "orbax":
        jfield = f["jfield"]
        like = _np_tree({"params": jfield, "opt_state": jrecon.make_optimizer(jrecon.ReconstructConfig(), 1000)
                         .init(jfield), "grid": np.zeros((129,) * 3, np.float32), "step": 0})
        got_j, want_j = jax_load_checkpoint(out, like), jax_load_checkpoint(os.path.join(f["root"], "jax_color"), like)
        assert jax.tree_util.tree_structure(got_j) == jax.tree_util.tree_structure(want_j)
        assert got_j["step"] == want_j["step"] == STATE_STEP + COLOR_STEPS
        for key in ("opt_state", "grid"):
            for x, y in zip(jax.tree_util.tree_leaves(got_j[key][0] if key == "opt_state" else got_j[key]),
                            jax.tree_util.tree_leaves(want_j[key][0] if key == "opt_state" else want_j[key])):
                assert np.asarray(x).dtype == np.asarray(y).dtype and np.array_equal(x, y), key
        # the port's train state keeps one count, Adam's, and writes it for the
        # schedule's too (JAX's trainers step both together); this hand-made
        # input state's schedule count is 0, which the JAX tool carries on
        assert int(got_j["opt_state"][1].count) == 2 and int(want_j["opt_state"][1].count) == 0


def test_finetune_color_from_a_baked_checkpoint_reaches_bake_and_eval(inputs, tmp_path, monkeypatch):
    """--ckpt with --grid_path: a fresh Adam state (zero moments, count 0)
    at step 0 + steps; the frozen leaves bitwise the checkpoint's; only the
    color MLP is handed to Adam, so the backward reaches no table (no
    reduce-scatter). The output is read by bake_artifact and eval_psnr."""
    f = inputs
    seen = []
    real = finetune_color.color_only

    def record(rest, shards):
        out = real(rest, shards)
        seen.append(([t.requires_grad for t in sorted_leaves(rest)], [s.requires_grad for s in shards], len(out)))
        return out

    monkeypatch.setattr(finetune_color, "color_only", record)
    out = str(tmp_path / "color.pt")
    got = finetune_color.main(["--ckpt", f["ckpt"], "--grid_path", f["grid17"], "--out", out, "--data_path",
                               f["data"], "--platform", "cpu", "--normal_mode", "fd4"] + COLOR_ARGV)
    assert got["step"] == COLOR_STEPS and len(got["losses"]) == COLOR_STEPS and np.isfinite(got["losses"]).all()
    (rest_grads, shard_grads, n_color), = seen
    assert shard_grads == [False] and n_color == sum(rest_grads) == len(jax.tree_util.tree_leaves(f["jfield"]["color"]))
    state = load_train_state(out, "cpu")
    assert state["count"] == 0 and state["step"] == COLOR_STEPS
    assert all(not t.any() for t in sorted_leaves(state["mu"]) + sorted_leaves(state["nu"]))
    np.testing.assert_array_equal(state["grid"].numpy(), np.load(f["grid17"]))
    base = _leaves_by_path(load_params_with_config(f["ckpt"], "cpu")[0])
    for k, v in _leaves_by_path(state["params"]).items():
        assert np.array_equal(v, base[k]) != k.startswith("['color']"), k

    _small_field_config(monkeypatch, jax_side=False)
    baked = str(tmp_path / "baked")
    bake = bake_artifact.main(["--state", out, "--out", baked, "--platform", "cpu", "--normal_mode", "fd4"])
    assert bake["step"] == COLOR_STEPS
    psnr = eval_psnr.main(["--state", out, "--data_path", f["data"], "--views", "0,1", "--level", "1",
                           "--platform", "cpu"])
    baked_psnr = eval_psnr.main(["--ckpt", os.path.join(baked, "bare_smpl_tpu.pth.tar"), "--grid_path",
                                 os.path.join(baked, "grid.npy"), "--data_path", f["data"], "--views", "0,1",
                                 "--level", "1", "--platform", "cpu"])
    assert psnr["step"] == COLOR_STEPS and np.isfinite(list(psnr["psnr"].values())).all()
    assert baked_psnr["psnr"].keys() == psnr["psnr"].keys()


# ---------------------------------------------------------------------------
# finetune_ss
# ---------------------------------------------------------------------------


def test_silhouette_band_and_draws_match_jax(inputs, jax_runs):
    """The band lists of the disc set's masks and every call's [S, B] view
    and pixel blocks (a quarter of the pixels from the band) bitwise the
    blocks JAX's scan received, drawn from one numpy generator."""
    ds = SMPLMultiviewDataset(inputs["data"])
    edge_mat, edge_len = finetune_ss.silhouette_band(ds.masks, 1)
    assert edge_mat.dtype == np.int32 and edge_len.dtype == np.int64 and (edge_len > 0).all()
    band = ds.masks.reshape(len(ds.masks), -1)
    for v in range(len(edge_len)):  # a band pixel lies on or next to the mask's edge
        assert 0 < band[v, edge_mat[v, : edge_len[v]]].mean() < 1
    rng = np.random.default_rng(0)
    views = finetune_color.train_views(ds.n_images, "13,62,95")
    assert views.tolist() == [0, 1, 2, 3]
    calls = jax_runs["ss_calls"]
    assert len(calls) == SS_CALLS
    for vis_j, pis_j, _ in calls:
        vis, pis = finetune_ss.draw_call(rng, views, 2, 32, ds.H * ds.W, 8, (edge_mat, edge_len))
        assert vis.dtype == vis_j.dtype and pis.dtype == pis_j.dtype
        assert np.array_equal(vis, vis_j) and np.array_equal(pis, pis_j)
        assert np.isin(pis[:, :8], edge_mat).all()


def test_finetune_ss_matches_jax(inputs, jax_runs, monkeypatch, tmp_path, capsys):
    """Three calls of 2 steps from the checkpoint and its 17^3 grid: the
    losses of every call and the final loss against JAX's; the grid
    refreshed once (after step 4) within the refresh bound of JAX's; the
    state saved at step 4 (``_latest``) and at the end (step 6), with the
    trainer's Adam count; fresh Adam, so the count equals the steps run."""
    f = inputs
    calls = []
    real = recon.make_train_scan_fast

    def recorded(*a, **kw):
        scan = real(*a, **kw)
        assert a[5:7] == ("raw", False) and kw["ss"] == 2  # the raw images on black
        return lambda *args: calls.append(scan(*args)) or calls[-1]

    monkeypatch.setattr(finetune_ss, "make_train_scan_fast", recorded)
    out = str(tmp_path / "ss")
    got = finetune_ss.main(["--ckpt", f["ckpt"], "--grid_path", f["grid17"], "--out", out, "--data_path", f["data"],
                            "--platform", "cpu"] + SS_ARGV)
    printed = capsys.readouterr()
    assert _last_json(printed.out) == got
    assert _band_line(printed.err) == jax_runs["ss_band"]  # the band's mean length and share, as JAX's
    want = jax_runs["ss"]
    assert {k: got[k] for k in ("steps", "ss")} == {k: want[k] for k in ("steps", "ss")} == {"steps": 6, "ss": 2}
    assert abs(got["final_loss"] - want["final_loss"]) <= LOSS_RTOL * abs(want["final_loss"])
    np.testing.assert_allclose(torch.cat(calls).numpy(), np.concatenate([c[2] for c in jax_runs["ss_calls"]]),
                               rtol=LOSS_RTOL)
    assert sorted(os.listdir(tmp_path)) == ["ss", "ss_latest"]  # orbax directories, as the JAX tool writes
    final, latest = load_train_state(out, "cpu"), load_train_state(out + "_latest", "cpu")
    assert (final["step"], final["count"], latest["step"], latest["count"]) == (6, 6, 4, 4)
    jgrid = load_train_state(os.path.join(f["root"], "jax_ss"), "cpu")["grid"]
    assert jgrid.shape == final["grid"].shape == (17, 17, 17)
    assert not np.array_equal(final["grid"].numpy(), np.load(f["grid17"]))  # refreshed
    np.testing.assert_allclose(final["grid"].numpy(), jgrid.numpy(), atol=GRID_ATOL, rtol=0)
    assert torch.equal(latest["grid"], final["grid"])  # saved after the refresh, as JAX's loop orders them
    jfield = f["jfield"]
    like = _np_tree({"params": jfield, "opt_state": jrecon.make_optimizer(jrecon.ReconstructConfig(), 6).init(jfield),
                     "grid": np.zeros((17,) * 3, np.float32), "step": 0})
    for path, step in ((out, 6), (out + "_latest", 4)):  # JAX restores both with its target
        state = jax_load_checkpoint(path, like)
        assert state["step"] == step and [int(s.count) for s in state["opt_state"]] == [step, step]
        np.testing.assert_array_equal(state["grid"], final["grid"].numpy())


# ---------------------------------------------------------------------------
# make_demo_body
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rig", ["root", "articulated"])
def test_make_demo_body_matches_jax(inputs, jax_runs, rig, tmp_path, capsys):
    """The .npz of each rig against JAX's: keys, dtypes and shapes exactly,
    faces, parents and rest_pose equal, the float arrays within BODY_ATOL;
    load_smpl reads it; render_warp_cli takes its rest_pose marker."""
    f = inputs
    out = str(tmp_path / f"{rig}.npz")
    got = make_demo_body.main(["--ckpt", f["ckpt"], "--out", out, "--platform", "cpu"] + BODY_ARGV[rig])
    assert _last_json(capsys.readouterr().out) == got
    a, b = np.load(out), np.load(os.path.join(f["root"], f"jax_{rig}.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        if a[k].dtype.kind == "f":
            rtol = REGRESSOR_RTOL if k == "J_regressor" else 0.0
            np.testing.assert_allclose(a[k], b[k], atol=BODY_ATOL, rtol=rtol, err_msg=k)  # NaN where JAX's is
        else:
            assert np.array_equal(a[k], b[k]), k
    assert got["joints"] == (7 if rig == "articulated" else 4) == len(a["parents"])
    assert got["vertices"] == len(a["v_template"]) > 0 and got["faces"] == len(a["faces"]) > 0
    body = load_smpl(out)
    assert body.n_joints == got["joints"] and np.array_equal(body.faces, a["faces"])
    np.testing.assert_array_equal(body.lbs_weights, a["lbs_weights"])
    assert render_warp_cli._rest_pose(render_warp_cli.build_parser().parse_args(["--smpl_path", out])) == "zero"
