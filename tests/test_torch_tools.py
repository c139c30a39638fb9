"""The port's offline tools (``avatarcraft_tpu_torch/tools/``: eval_psnr,
eval_style, bake_artifact, prune_grid, style_delta) against the JAX
package's root ``tools/``, on the CPU, at small sizes: a 16x16 disc set of
4 views, a pyramid field with f32 tables (tests/test_torch_stylize.py's),
the TINY toy guidance, 2 views at 16x16 for eval_style, a 17^3 refresh
for prune_grid. Each JAX tool's ``main`` runs once, in the module fixture
``jax_runs``; the port's tools run with ``--platform cpu``. The parsers of
the fine-tune and asset tools (finetune_color, finetune_ss,
train_toy_guidance, make_demo_body; held to JAX in
tests/test_torch_finetune.py and tests/test_torch_toy_train.py) are
compared here with the others'.

Tolerances:
* eval_psnr: every per-view PSNR, the mean and the band statistics'
  interior PSNR within 1e-3 dB of JAX's; the band fractions exact (masks
  only) and the band's share of the MSE within 1e-4; the JSON's other
  fields exact; the PNGs within one level of JAX's (renders within the
  render pin, truncated to uint8);
* eval_style: every number of the JSON within 1e-4 relative of JAX's, or
  within RENDER_ATOL (2e-3, tests/test_torch_render.py's render pin) where
  that is wider (the hue histograms' and centroids' entries, rounded to 4
  and 5 decimals, and the numbers near 0); None exactly where JAX's is
  None; tier 3 with JAX's initial latents injected (the port draws its
  own from a torch.Generator);
* bake_artifact: the .pth.tar state dict (keys, dtypes, values), grid.npy
  and the .fieldcfg.json bitwise JAX's, PROVENANCE.json equal;
* prune_grid: the kept-cell mask, the saved grid and the printed counts
  exactly JAX's, on a field of two blobs (418 and 36 cells) whose densities
  lie at least 8 away from the threshold (the refresh itself is held at
  512^2/4 x 1e-6 in tests/test_torch_train.py);
* style_delta pack: every array of the .npz bitwise JAX's and meta_json's
  bytes equal, on a small base and a styled field perturbed in 17 rows of
  its sparse leaf and everywhere in its dense ones.
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from avatarcraft_tpu.models import instant_nsr as jnsr
from avatarcraft_tpu.models import toy_guidance as jtoy
from avatarcraft_tpu.ops.grid_encoder import PyramidSpec as JaxPyramidSpec
from avatarcraft_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from avatarcraft_tpu.workloads import reconstruct as jrecon
from avatarcraft_tpu_torch.models import instant_nsr as nsr
from avatarcraft_tpu_torch.models import sd, toy_guidance
from avatarcraft_tpu_torch.tools import bake_artifact, eval_psnr, eval_style, prune_grid, style_delta
from avatarcraft_tpu_torch.utils.checkpoint import (
    load_params_with_config,
    params_from_jax,
    save_params_with_config,
    sorted_leaf_paths,
    sorted_leaves,
    train_state_from_optax,
)
from avatarcraft_tpu_torch.utils.png import read_png
from test_torch_dataset import write_blender_set
from tools import bake_artifact as jbake
from tools import eval_psnr as jeval_psnr
from tools import eval_style as jeval_style
from tools import prune_grid as jprune
from tools import style_delta as jstyle_delta

PSNR_ATOL = 1e-3  # dB
SHARE_ATOL = 1e-4
STYLE_RTOL = 1e-4
RENDER_ATOL = 2e-3  # tests/test_torch_render.py's render pin
# tests/test_torch_stylize.py's small widths, f32 tables, and its TINY toy guidance
JAX_FCFG = jnsr.FieldConfig(
    encoder="tpu_pyramid", packed_dtype="float32",
    pyramid=JaxPyramidSpec(grid_resolutions=(4, 8), grid_dim=2, plane_resolutions=(17,), plane_dim=2),
)
FCFG = nsr.FieldConfig(encoder="tpu_pyramid", packed_dtype="float32",
                       pyramid=nsr.PyramidSpec(grid_resolutions=(4, 8), grid_dim=2, plane_resolutions=(17,),
                                               plane_dim=2))
JAX_TINY = jtoy.ToyGuidanceConfig(
    image_size=16, emb_dim=8, seq_len=2, block_out_channels=(8, 16), layers_per_block=1,
    attention_head_dim=2, norm_groups=4, attn_blocks=(False, True),
)
TINY = toy_guidance.ToyGuidanceConfig(**dataclasses.asdict(JAX_TINY))
# eval_psnr's two JAX runs: a baked checkpoint on a composited ground truth,
# and an orbax train state against the raw images, supersampled and boxed
PSNR_CKPT_ARGV = ["--views", "0,2", "--level", "1", "--band_stats"]
PSNR_STATE_ARGV = ["--views", "1,3", "--level", "2", "--gt_mode", "raw", "--supersample", "2", "--gt_box",
                   "--band_stats"]
STYLE_ARGV = ["--style", "lava", "--views", "2", "--res", "16", "--txt2img_n", "2", "--txt2img_steps", "2"]
STATE_STEP = 7
_JAX_INIT = jnsr.init_field_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work (tier-1 runs six
    pytest workers on the machine's cores). Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(jparams):
    return params_from_jax(jparams, device="cpu")


def _drawn(shapes, rng, scale: float = 0.3):
    """A tree of the shapes of ``jax.eval_shape``'s tree ``shapes`` (no
    compile), filled with seeded normals times ``scale``."""
    return jax.tree_util.tree_map(lambda a: (rng.normal(size=a.shape) * scale).astype(a.dtype), shapes)


def _field(jcfg, seed: int, bias: float = -1.0):
    """A small field of ``jcfg`` whose SDF depends on the tables and has a
    surface (tests/test_torch_stylize.py's ``_field``), drawn in numpy: the
    JAX package's init, eager, compiles op by op."""
    rng = np.random.default_rng(seed)
    jp = _drawn(jax.eval_shape(lambda k: _JAX_INIT(k, jcfg), jax.random.PRNGKey(0)), rng)
    last = jp["sdf"][-1]["v"]
    last[:] = np.sqrt(np.pi) / np.sqrt(last.shape[1]) + 1e-4 * rng.normal(size=last.shape)
    for layer in jp["sdf"] + jp["color"]:
        layer["g"] = np.linalg.norm(layer["v"], axis=1)
    for layer in jp["sdf"]:
        layer["b"][:] = 0.0
    jp["sdf"][-1]["b"][0] = bias
    jp["variance"] = np.float32(0.3)
    return jp


def _blob_field():
    """A field of JAX_FCFG whose SDF is the first channel of the 8^3 grid
    level: +0.5, and -0.5 in a 3^3 block and in two cells far from it; so
    its 17^3 refresh holds two 26-connected components."""
    jp = _field(JAX_FCFG, 0)
    jp["grids"] = [np.zeros_like(g) for g in jp["grids"]]
    jp["planes"] = [np.zeros_like(p) for p in jp["planes"]]
    pattern = np.full(jp["grids"][1].shape[:3], 0.5, np.float32)
    pattern[1:4, 1:4, 1:4] = -0.5
    pattern[6, 6, 5:7] = -0.5
    jp["grids"][1][..., 0] = pattern
    # sdf = softplus100(f) - softplus100(-f) = f, f the sum of the encoder's features
    v0 = np.zeros_like(jp["sdf"][0]["v"])
    v0[0, 3:], v0[1, 3:] = 1.0, -1.0
    v1 = np.zeros_like(jp["sdf"][1]["v"])
    v1[:, :2] = [1.0, -1.0]
    jp["sdf"] = [{"v": v, "g": np.linalg.norm(v, axis=1), "b": np.zeros_like(layer["b"])}
                 for v, layer in zip((v0, v1), jp["sdf"])]
    return jp


def _disc_set(root):
    """4 views at 16x16 of a white disc on black, cameras at distance 2
    around the y axis (tests/test_torch_reconstruct_cli.py's set)."""
    poses, images = [], []
    for angle in (0.0, np.pi / 2, np.pi, 1.5 * np.pi):
        c, s = np.cos(angle), np.sin(angle)
        poses.append(np.array([[c, 0, s, 2 * s], [0, 1, 0, 0], [-s, 0, c, 2 * c], [0, 0, 0, 1]], np.float32))
        img = np.zeros((16, 16, 3), np.uint8)
        yy, xx = np.mgrid[:16, :16]
        img[(yy - 8) ** 2 + (xx - 7) ** 2 < 25] = 255
        images.append(img)
    write_blender_set(root, np.stack(images), np.stack(poses), camera_angle_x=1.0471975511965976)


def _save_field(jparams, path):
    save_params_with_config(_port(jparams), path, FCFG)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The files every tool reads: the disc set, a field checkpoint with its
    17^3 grid, the same field as a JAX orbax train state (a 129^3 grid,
    optax Adam's state after two updates) and as the port's state file, a
    bare artifact directory and a styled checkpoint for eval_style, the
    TINY toy guidance in the port's layout, the blob field, and a base and
    styled pair for style_delta."""
    root = tmp_path_factory.mktemp("tools")
    f = {"root": str(root), "data": str(root / "disc")}
    _disc_set(f["data"])
    rng = np.random.default_rng(3)
    jfield = _field(JAX_FCFG, 0)
    f["ckpt"], f["grid17"] = str(root / "field.pth.tar"), str(root / "grid17.npy")
    _save_field(jfield, f["ckpt"])
    np.save(f["grid17"], np.where(rng.random((17,) * 3) < 0.6, 50.0, 0.5).astype(np.float32))

    # optax Adam's state of the JAX trainer, its moments and count as after two steps
    opt_state = jrecon.make_optimizer(jrecon.ReconstructConfig(), 1000).init(jfield)
    adam = opt_state[0]._replace(mu=_drawn(jfield, rng, 1e-3), nu=jax.tree_util.tree_map(np.square, _drawn(jfield, rng, 1e-3)),
                                 count=np.asarray(2, np.int32))
    opt_state = (adam,) + tuple(opt_state[1:])
    grid129 = np.where(rng.random((129,) * 3) < 0.6, 50.0, 0.5).astype(np.float32)
    f["orbax"] = str(root / "state_orbax")
    jax_save_checkpoint(f["orbax"], {"params": jfield, "opt_state": _np_tree(opt_state), "grid": grid129,
                                     "step": STATE_STEP})
    f["pt"] = str(root / "state.pt")
    train_state_from_optax(f["pt"], jfield, adam.mu, adam.nu, int(adam.count), STATE_STEP, grid129)

    f["bare"] = str(root / "bare")
    os.makedirs(f["bare"])
    _save_field(jfield, os.path.join(f["bare"], "bare_smpl_tpu.pth.tar"))
    np.save(os.path.join(f["bare"], "grid.npy"), np.load(f["grid17"]))
    f["styled"] = str(root / "styled.pth.tar")
    _save_field(_field(JAX_FCFG, 1), f["styled"])
    f["jtoy"] = _drawn(jax.eval_shape(lambda k: jtoy.init_toy_params(k, JAX_TINY), jax.random.PRNGKey(2)), rng,
                       0.1)
    f["toy"] = str(root / "toy")
    toy_guidance.save_toy_guidance(f["toy"], sd.params_from_jax(f["jtoy"], "cpu"), TINY,
                                   torch.from_numpy(np.array(jtoy.style_embeddings(JAX_TINY))))

    f["blob"] = str(root / "blob.pth.tar")
    _save_field(_blob_field(), f["blob"])

    # style_delta: a plane level of 129^2 x 3 x 2 = 99,846 elements, stored by rows
    pack_jcfg = dataclasses.replace(JAX_FCFG, pyramid=JaxPyramidSpec(grid_resolutions=(4,), grid_dim=2,
                                                                      plane_resolutions=(129,), plane_dim=2))
    base = _field(pack_jcfg, 4)
    leaves, treedef = jax.tree_util.tree_flatten(base)
    styled = [np.array(x, np.float32) for x in leaves]
    for x in styled:
        if x.size >= style_delta.SPARSE_MIN_ELEMS:
            rows = x.reshape(-1, x.shape[-1])
            rows[rng.choice(rows.shape[0], size=17, replace=False)] += rng.normal(size=(17, rows.shape[1])) * 0.01
        else:
            x += rng.normal(size=x.shape).astype(np.float32) * 1e-3
    pack_fcfg = dataclasses.replace(FCFG, pyramid=nsr.PyramidSpec(**dataclasses.asdict(pack_jcfg.pyramid)))
    f["pack_base"], f["pack_styled"] = str(root / "pbase.pth.tar"), str(root / "pstyled.pth.tar")
    save_params_with_config(_port(base), f["pack_base"], pack_fcfg)
    save_params_with_config(_port(jax.tree_util.tree_unflatten(treedef, styled)), f["pack_styled"], pack_fcfg)
    return f


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def _run_jax(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(argv)
    return out.getvalue()


def _small_field_config(patch, jax_side: bool):
    """The tools build FieldConfig(encoder=...) at the reference's widths
    for a train state; here they get the small widths of the state."""
    module, small = (jnsr, JAX_FCFG) if jax_side else (nsr, FCFG)
    real = module.FieldConfig
    patch.setattr(module, "FieldConfig", lambda encoder, **kw: real(encoder=encoder, **kw) if kw else small)


def _refresh_17(module, zeros):
    """The tool's 129^3 refresh from zeros, done on a 17^3 lattice of
    ``zeros((17,) * 3)``."""
    real = module.make_grid_update_fn

    def small(fcfg, bound):
        refresh = real(fcfg, bound)
        return lambda p, g: refresh(p, zeros((17,) * 3) if g.shape[0] == 129 else g)

    return small


def _jax_latents(n: int):
    """JAX's eval_style draw: jax.random.normal(PRNGKey(0), [n, C, S, S])."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n, 3, JAX_TINY.image_size, JAX_TINY.image_size)))


@pytest.fixture(scope="module")
def jax_runs(inputs):
    """Each JAX tool's main once, with --platform cpu where it has one:
    its printed JSON (prune_grid: its line) and the directories it wrote."""
    f, root = inputs, inputs["root"]
    runs = {}
    with pytest.MonkeyPatch.context() as m:
        runs["psnr_ckpt"] = _last_json(_run_jax(jeval_psnr.main, [
            "--ckpt", f["ckpt"], "--grid_path", f["grid17"], "--data_path", f["data"], "--platform", "cpu",
            "--out_dir", os.path.join(root, "jax_png")] + PSNR_CKPT_ARGV))
        _small_field_config(m, jax_side=True)
        # the like-tree of the restore, drawn in numpy (its values are replaced)
        m.setattr(jnsr, "init_field_params", lambda key, jcfg: _field(jcfg, 0))
        runs["psnr_state"] = _last_json(_run_jax(jeval_psnr.main, [
            "--state", f["orbax"], "--data_path", f["data"], "--platform", "cpu"] + PSNR_STATE_ARGV))
        with open(os.path.join(root, "psnr.json"), "w") as fp:
            json.dump(runs["psnr_state"], fp)
        runs["bake"] = _last_json(_run_jax(jbake.main, [
            "--state", f["orbax"], "--out", os.path.join(root, "jax_bake"), "--normal_mode", "fd4",
            "--psnr_json", os.path.join(root, "psnr.json")]))
        m.setattr(jtoy, "load_toy_guidance", lambda path: (f["jtoy"], JAX_TINY))
        runs["style"] = _last_json(_run_jax(jeval_style.main, [
            "--ckpt", f["styled"], "--bare", f["bare"], "--guidance", f["toy"], "--platform", "cpu",
            "--save_pngs", os.path.join(root, "jax_style_png")] + STYLE_ARGV))
        m.setattr(jrecon, "make_grid_update_fn", _refresh_17(jrecon, jax.numpy.zeros))
        runs["prune"] = _run_jax(jprune.main, ["--ckpt", f["blob"], "--out", os.path.join(root, "jax_pruned.npy"),
                                               "--platform", "cpu"]).strip()
        runs["pack"] = _last_json(_run_jax(jstyle_delta.main, [
            "pack", "--base", f["pack_base"], "--styled", f["pack_styled"], "--out",
            os.path.join(root, "jax_delta.npz"), "--grid", f["grid17"]]))
    return runs


# ---------------------------------------------------------------------------
# eval_style's numeric core
# ---------------------------------------------------------------------------


def test_hue_statistics_match_the_root_tool(rng):
    """rgb_to_hsv, hue_stats (with and without a mask), circular_emd,
    chroma_dist and chroma_angle_deg on seeded colours within 1e-12 of the
    root tool's, with the gray and achromatic cases (None where it gives
    None) and the same HUE_WEIGHT_FLOOR and bin count."""
    assert eval_style.HUE_WEIGHT_FLOOR == jeval_style.HUE_WEIGHT_FLOOR
    assert eval_style.N_HUE_BINS == jeval_style.N_HUE_BINS
    rgb = rng.random((6, 9, 3))
    rgb[0] = 0.42  # gray: zero chroma
    rgb[1, :, 0] = rgb[1, :, 1]  # ties between channels
    for got, want in zip(eval_style.rgb_to_hsv(rgb), jeval_style.rgb_to_hsv(rgb)):
        np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    gray = 0.5 + 0.004 * rng.standard_normal((1, 64, 3))
    mask = rng.random((6, 9)) < 0.5
    for img, m in ((rgb, None), (rgb, mask), (gray, None), (rgb[:0], None)):
        got, want = eval_style.hue_stats(img, m), jeval_style.hue_stats(img, m)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(got[k], want[k], atol=1e-12, rtol=0, err_msg=k)
    p, q, z = rng.random(16), rng.random(16), np.zeros(16)
    for a, b in ((p, q), (q, p), (p, z), (z, q)):
        got, want = eval_style.circular_emd(a, b), jeval_style.circular_emd(a, b)
        assert (got is None) == (want is None) and (got is None or abs(got - want) <= 1e-12)
    assert eval_style.circular_emd(p, z) is None
    for a, b in ((p[:2], q[:2]), ([0.3, -0.2], [1e-4, 0.0]), ([0.0, 0.0], [0.0, 0.0])):
        assert abs(eval_style.chroma_dist(a, b) - jeval_style.chroma_dist(a, b)) <= 1e-12
        got, want = eval_style.chroma_angle_deg(a, b), jeval_style.chroma_angle_deg(a, b)
        assert (got is None) == (want is None) and (got is None or abs(got - want) <= 1e-12)


# ---------------------------------------------------------------------------
# eval_psnr
# ---------------------------------------------------------------------------


def _assert_psnr_json(got: dict, want: dict):
    for k in ("step", "level", "supersample", "gt_mode", "normal_mode"):
        assert got[k] == want[k], k
    got, want = json.loads(json.dumps(got)), json.loads(json.dumps(want))  # the printed keys
    assert got["psnr"].keys() == want["psnr"].keys()
    for v in want["psnr"]:
        assert abs(got["psnr"][v] - want["psnr"][v]) <= PSNR_ATOL, (v, got["psnr"][v], want["psnr"][v])
    assert abs(got["mean_psnr"] - want["mean_psnr"]) <= PSNR_ATOL
    assert got.keys() == want.keys()
    for v, w in want.get("band_stats", {}).items():
        g = got["band_stats"][v]
        assert g["band_frac"] == w["band_frac"]
        assert abs(g["band_mse_share"] - w["band_mse_share"]) <= SHARE_ATOL
        assert abs(g["interior_psnr"] - w["interior_psnr"]) <= PSNR_ATOL


@pytest.mark.parametrize("source", ["ckpt", "orbax", "pt"])
def test_eval_psnr_matches_jax(inputs, jax_runs, source, monkeypatch, tmp_path, capsys):
    """--ckpt with --grid_path (composited ground truth on white, level 1,
    band statistics, PNGs), and --state on the JAX orbax state and on the
    port's state file of the same field (raw, level 2, --supersample 2,
    --gt_box, band statistics), against JAX's runs of the same flags (the
    port's state file against JAX's run on the orbax directory)."""
    f = inputs
    if source == "ckpt":
        argv = ["--ckpt", f["ckpt"], "--grid_path", f["grid17"], "--out_dir", str(tmp_path)] + PSNR_CKPT_ARGV
        want = jax_runs["psnr_ckpt"]
    else:
        _small_field_config(monkeypatch, jax_side=False)
        argv = ["--state", f[source]] + PSNR_STATE_ARGV
        want = jax_runs["psnr_state"]
    got = eval_psnr.main(argv + ["--data_path", f["data"], "--platform", "cpu"])
    assert _last_json(capsys.readouterr().out) == json.loads(json.dumps(got))
    _assert_psnr_json(got, want)
    assert got["step"] == (-1 if source == "ckpt" else STATE_STEP)
    if source == "ckpt":
        names = sorted(os.listdir(tmp_path))
        assert names == sorted(os.listdir(os.path.join(f["root"], "jax_png"))) == ["eval_v0_s-1.png",
                                                                                   "eval_v2_s-1.png"]
        for name in names:
            a, b = read_png(str(tmp_path / name)), read_png(os.path.join(f["root"], "jax_png", name))
            assert a.shape == b.shape == (16, 16, 3)
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_eval_psnr_white_bkg_is_read_as_a_boolean(inputs, jax_runs, monkeypatch):
    """The JAX tool's --white_bkg (tools/eval_psnr.py:45) has no type: the
    string "false" is true, so its composite still renders and composites
    on white (its render is called with bg 1.0). The port reads the flag
    as a boolean: with --white_bkg false it renders on black, and on this
    black-backed set (the mask is any channel != 0) its composite ground
    truth equals the raw images, so it gives JAX's --gt_mode raw numbers."""
    f = inputs
    seen = []

    class Stop(Exception):
        pass

    def record(p, ro, rd, fcfg, fast_cfg, g, bg):
        seen.append(bg)
        raise Stop

    monkeypatch.setattr(jnsr, "render_rays_fast", record)
    with pytest.raises(Stop):
        jeval_psnr.main(["--ckpt", f["ckpt"], "--grid_path", f["grid17"], "--data_path", f["data"],
                         "--platform", "cpu", "--views", "0", "--white_bkg", "false"])
    assert seen == [1.0]
    _small_field_config(monkeypatch, jax_side=False)
    argv = ["--state", f["orbax"], "--data_path", f["data"], "--platform", "cpu", "--white_bkg", "false"]
    got = eval_psnr.main(argv + [a for a in PSNR_STATE_ARGV if a not in ("--gt_mode", "raw")])
    assert got["gt_mode"] == "composite"
    _assert_psnr_json({**got, "gt_mode": "raw"}, jax_runs["psnr_state"])


# ---------------------------------------------------------------------------
# eval_style
# ---------------------------------------------------------------------------


def _assert_close_json(got, want, path=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_close_json(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close_json(g, w, f"{path}[{i}]")
    elif want is None or isinstance(want, str):
        assert got == want, path
    else:
        assert got is not None and abs(got - want) <= max(STYLE_RTOL * abs(want), RENDER_ATOL), (path, got, want)


def test_eval_style_matches_jax(inputs, jax_runs, monkeypatch, tmp_path, capsys):
    """The three tiers on a styled field against the bare artifact, 2 views
    at 16x16, tier 3 with 2 txt2img samples of 2 PNDM steps from JAX's
    initial latents; the PNGs within one level of JAX's."""
    f = inputs
    real = eval_style.initial_latents

    def jax_draw(guidance, n, size, seed, device):
        assert real(guidance, n, size, seed, device).shape == (n, 3, size, size)
        return torch.from_numpy(np.array(_jax_latents(n)))

    monkeypatch.setattr(eval_style, "initial_latents", jax_draw)
    got = eval_style.main(["--ckpt", f["styled"], "--bare", f["bare"], "--guidance", f["toy"], "--platform", "cpu",
                           "--save_pngs", str(tmp_path), "--out", str(tmp_path / "out.json")] + STYLE_ARGV)
    printed = _last_json(capsys.readouterr().out)
    with open(tmp_path / "out.json") as fp:
        assert json.load(fp) == printed == json.loads(json.dumps(got))
    want = jax_runs["style"]
    assert got["ckpt"] == want["ckpt"] == f["styled"]
    assert got["views"][0]["fg_frac"] > 0  # the renders show a foreground
    _assert_close_json(got, want)
    jdir = os.path.join(f["root"], "jax_style_png")
    assert sorted(os.listdir(tmp_path)) == sorted(os.listdir(jdir) + ["out.json"])
    for name in os.listdir(jdir):
        a, b = read_png(str(tmp_path / name)), read_png(os.path.join(jdir, name))
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, name


# ---------------------------------------------------------------------------
# bake_artifact, prune_grid, style_delta
# ---------------------------------------------------------------------------


def test_bake_artifact_matches_jax_bitwise(inputs, jax_runs, monkeypatch, capsys):
    """From the JAX orbax state: the state dict, grid.npy and the sidecar
    bitwise JAX's bake; PROVENANCE.json equal (step, encoder, fp16 tables,
    the normal mode and the embedded eval JSON); the JSON line's files."""
    f, root = inputs, inputs["root"]
    _small_field_config(monkeypatch, jax_side=False)
    out, jout = os.path.join(root, "port_bake"), os.path.join(root, "jax_bake")
    got = bake_artifact.main(["--state", f["orbax"], "--out", out, "--normal_mode", "fd4", "--psnr_json",
                              os.path.join(root, "psnr.json"), "--platform", "cpu"])
    assert _last_json(capsys.readouterr().out) == got
    want = jax_runs["bake"]
    assert got["step"] == want["step"] == STATE_STEP and got["bytes"].keys() == want["bytes"].keys()
    a = torch.load(os.path.join(out, "bare_smpl_tpu.pth.tar"), weights_only=True)
    b = torch.load(os.path.join(jout, "bare_smpl_tpu.pth.tar"), weights_only=True)
    assert list(a) == list(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and torch.equal(a[k], b[k]), k
    assert a["pyramid.grids.0"].dtype == torch.float16 and a["sdf_net.0.weight_v"].dtype == torch.float32
    for name in ("bare_smpl_tpu.pth.tar.fieldcfg.json", "PROVENANCE.json"):
        with open(os.path.join(out, name), "rb") as fa, open(os.path.join(jout, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    ga, gb = np.load(os.path.join(out, "grid.npy")), np.load(os.path.join(jout, "grid.npy"))
    assert ga.dtype == gb.dtype == np.float32 and np.array_equal(ga, gb)


@pytest.mark.parametrize("min_cells", [0, 30])
def test_prune_grid_matches_jax(inputs, jax_runs, monkeypatch, tmp_path, capsys, min_cells):
    """The 17^3 refresh of the blob field: at the default (the largest
    component) the printed line, the kept mask and the saved grid are
    JAX's; with --min_cells 30 both components stay."""
    monkeypatch.setattr(prune_grid, "make_grid_update_fn", _refresh_17(prune_grid, torch.zeros))
    out = str(tmp_path / "pruned.npy")
    got = prune_grid.main(["--ckpt", inputs["blob"], "--out", out, "--platform", "cpu", "--min_cells",
                           str(min_cells)])
    line = capsys.readouterr().out.strip()
    want_line = jax_runs["prune"]
    jout = os.path.join(inputs["root"], "jax_pruned.npy")
    assert got["components"] == 2 and got["occupied"] == 454
    if min_cells == 0:
        assert line == want_line.replace(jout, out)
        assert (got["kept"], got["kept_components"]) == (418, 1)
        a, b = np.load(out), np.load(jout)
        assert a.dtype == b.dtype and np.array_equal(a > 0, b > 0)
        np.testing.assert_allclose(a, b, atol=512.0**2 / 4 * 1e-6, rtol=0)
    else:
        assert (got["kept"], got["kept_components"]) == (454, 2)


def test_style_delta_pack_matches_jax_bitwise(inputs, jax_runs, tmp_path, capsys):
    """pack: the JSON line's counts, every array of the .npz bitwise and
    meta_json's bytes equal to JAX's; unpack of it gives the styled field
    within fp16's rounding of the row differences."""
    f = inputs
    out = str(tmp_path / "delta.npz")
    got = style_delta.main(["pack", "--base", f["pack_base"], "--styled", f["pack_styled"], "--out", out,
                            "--grid", f["grid17"], "--platform", "cpu"])
    assert _last_json(capsys.readouterr().out) == got
    want = jax_runs["pack"]
    assert got["sparse_rows_changed"] == want["sparse_rows_changed"] == 17
    assert got["sparse_rows_total"] == want["sparse_rows_total"]
    a, b = np.load(out), np.load(os.path.join(f["root"], "jax_delta.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    meta = json.loads(bytes(a["meta_json"]).decode())
    assert [t["mode"] for t in meta["tensors"]].count("sparse_rows") == 1

    styled = str(tmp_path / "styled.pth.tar")
    res = style_delta.main(["unpack", "--base", f["pack_base"], "--delta", out, "--out", styled, "--grid_out",
                            str(tmp_path / "g.npy"), "--platform", "cpu"])
    assert res == {"out": styled, "tensors": len(meta["tensors"]), "grid": True}
    np.testing.assert_array_equal(np.load(tmp_path / "g.npy"), np.load(f["grid17"]).astype(np.float16))
    for x, y in zip(sorted_leaves(load_params_with_config(styled, "cpu")[0]),
                    sorted_leaves(load_params_with_config(f["pack_styled"], "cpu")[0])):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=2e-5, rtol=0)


def test_style_delta_leaf_paths_are_jax_keystr(inputs):
    """sorted_leaf_paths writes jax.tree_util.keystr's strings, in
    tree_flatten's order."""
    jp = _field(JAX_FCFG, 0)
    want = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert sorted_leaf_paths(_port(jp)) == want


@pytest.mark.parametrize("what", ["fieldcfg", "tree"])
def test_style_delta_pack_refuses_other_bases(inputs, tmp_path, what):
    """pack refuses a styled field whose FieldConfig or tree differs from
    the base's, before writing anything, as JAX's does."""
    f = inputs
    other = str(tmp_path / "other.pth.tar")
    if what == "fieldcfg":
        save_params_with_config(_port(_field(JAX_FCFG, 0)), other, dataclasses.replace(FCFG, hidden_dim=63))
        match = "FieldConfigs differ"
    else:
        params = _port(_field(JAX_FCFG, 0))
        del params["planes"]
        save_params_with_config(params, other, FCFG)
        match = "tree mismatch"
    with pytest.raises(SystemExit, match=match):
        style_delta.main(["pack", "--base", f["ckpt"], "--styled", other, "--out", str(tmp_path / "d.npz"),
                          "--platform", "cpu"])
    assert not os.path.exists(tmp_path / "d.npz")


# ---------------------------------------------------------------------------
# the parsers
# ---------------------------------------------------------------------------


class _Parsed(Exception):
    pass


def _jax_parser(main, argv=("x",)):
    """The argparse parser a root tool's main builds (caught at its parse)."""
    real = argparse.ArgumentParser.parse_args

    def catch(self, args=None, namespace=None):
        raise _Parsed(self)

    argparse.ArgumentParser.parse_args = catch
    try:
        main(list(argv))
    except _Parsed as caught:
        return caught.args[0]
    finally:
        argparse.ArgumentParser.parse_args = real
    raise AssertionError("the tool parsed no arguments")


def _flags(parser):
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        if isinstance(a, argparse._SubParsersAction):
            out[a.dest] = {name: _flags(p) for name, p in a.choices.items()}
            continue
        typed = None if a.type is None else a.type if a.type in (int, float) \
            else [a.type(s) for s in ("3", "false", "True")]
        out[a.dest] = (tuple(a.option_strings), a.default, a.choices, a.required, type(a).__name__, typed)
    return out


TOOL_NAMES = ["eval_psnr", "eval_style", "bake_artifact", "prune_grid", "style_delta", "finetune_color",
              "finetune_ss", "train_toy_guidance", "make_demo_body"]


@pytest.mark.parametrize("name", TOOL_NAMES)
def test_parsers_match_jax(name):
    """Each tool's flags, defaults, choices and types are the root tool's,
    except where the port differs on purpose: ``--platform`` defaults to
    the card (``default``) where the JAX eval_psnr, prune_grid and
    make_demo_body default to ``cpu``, bake_artifact, style_delta and the
    two fine-tunes (which run where JAX puts them, no flag) take it too,
    eval_psnr reads ``--white_bkg`` as a boolean, and eval_psnr and the
    fine-tunes default ``--data_path`` to reconstruct_cli's."""
    import importlib

    port = importlib.import_module(f"avatarcraft_tpu_torch.tools.{name}")
    jmain = importlib.import_module(f"tools.{name}").main
    got, want = _flags(port.build_parser()), _flags(_jax_parser(jmain))
    platform = (("--platform",), "default", ["cpu", "default"], False, "_StoreAction", None)
    if name == "style_delta":
        for sub in ("pack", "unpack"):
            assert got["cmd"][sub].pop("platform") == platform
    elif name in ("bake_artifact", "finetune_color", "finetune_ss"):
        assert "platform" not in want
        assert got.pop("platform") == platform
    else:
        jplat = want.pop("platform")
        assert got.pop("platform") == platform
        assert jplat[1] == ("default" if name in ("eval_style", "train_toy_guidance") else "cpu")
    if name in ("finetune_color", "finetune_ss"):
        assert want.pop("data_path")[1].endswith("/data/smpl_da_512")
        assert got.pop("data_path")[1] == "data/smpl_da_512"
    if name == "eval_psnr":
        # the JAX tool's set lies at an absolute path of its own machine; the
        # port's default is reconstruct_cli's, relative to the working directory
        assert want.pop("data_path")[1].endswith("/data/smpl_da_512")
        assert got.pop("data_path")[1] == "data/smpl_da_512"
        assert want["white_bkg"][1:] == (True, None, False, "_StoreAction", None)  # a string: "false" is true
        assert got["white_bkg"][1:] == (True, None, False, "_StoreAction", [False, False, True])
        got.pop("white_bkg"), want.pop("white_bkg")
    assert got == want
