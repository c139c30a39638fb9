"""The port's probes and post-processing tools (``avatarcraft_tpu_torch/
tools/``: synth_gt_band_check, profile_stylize_fine, sds_scale_probe,
make_sbs_gif, postprocess_multi.sh) against the JAX package's root
``tools/``, on the CPU, at small sizes: tests/test_torch_tools.py's 16x16
disc set and its pyramid field with f32 tables, a 17^3 grid, the tiny SD
configs of tests/test_sd_modules.py, the committed grid and toy guidance
where a number depends on them. The port's tools run with ``--platform cpu``.

Tolerances:
* synth_gt_band_check (view 1 at side 16, ss 2 and 2; the JAX tool's
  renders handed to it with the opacity as [N], the shape it was written
  for, where JAX's render_rays_fast now gives [N, 1] and the tool raises):
  no hard-coverage
  subsample flipped (w on the other side of 0.5 from JAX's; 0 allowed);
  both renders' colours and opacities within RENDER_ATOL (2e-3,
  tests/test_torch_render.py's render pin) of JAX's; the band mask and
  ``band_frac_of_pixels`` exactly JAX's; the two PSNRs within PSNR_ATOL
  (2e-3 dB: 1e-3 for the renders plus the JSON's rounding to 3 decimals)
  and ``band_mse_share`` within SHARE_ATOL (1e-4 plus its rounding to 5);
  the other keys equal;
* profile_stylize_fine: at its defaults (the committed grid and toy
  guidance, batch 32,768 on a 256x256 frame) the derived budget and
  ``occ_frac_start`` exactly JAX's, and the whole JSON but its two
  timings, with the trainer stubbed on both sides (the budget and the
  occupancy do not depend on it); then 7 real steps at a 16x16 frame
  (``StylizeConfig`` patched on both sides: no flag sets H and W), batch
  64, no refresh: the same JSON keys, the same config and budget, finite
  timings;
* sds_scale_probe: ``unet_params_M`` exactly JAX's at the full SD 1.5
  (both counted without allocating: ``jax.eval_shape`` and the port's
  ``meta`` device); one step at the tiny SD configs with a 32x32 guidance
  image and the small field, patched on both sides (JAX's trees drawn in
  numpy: its eager inits compile op by op): the same JSON keys, the same
  UNet count, finite timings, no memory numbers on the CPU;
* make_sbs_gif: the frame count, size, delays and loop count of JAX's GIF,
  and the decoded frames' mean absolute error against the paired PNGs at
  most JAX's plus one level (tests/test_torch_outputs.py's GIF bound);
* postprocess_multi.sh: run end to end on the CPU (PLATFORM=cpu) at RES 16,
  TRAJ 2 and one prompt in a temporary tree: every output file the JAX
  script writes is there, and the eval JSON's and the GIFs' contents
  well-formed; its numeric tag read as decimal where the root script's
  printf reads a zero-padded one as octal (both tag blocks run by bash).
"""

import dataclasses
import functools
import json
import os
import shutil
import subprocess

import jax
import numpy as np
import pytest
import scipy.ndimage
import torch

from avatarcraft_tpu import cameras as jcameras
from avatarcraft_tpu.models import diffusion as jdiff
from avatarcraft_tpu.models import instant_nsr as jnsr
from avatarcraft_tpu.models import sd as jsd
from avatarcraft_tpu.models import toy_guidance as jtoy
from avatarcraft_tpu.workloads import stylize as jstylize
from avatarcraft_tpu_torch.cameras import pose2rays
from avatarcraft_tpu_torch.models import instant_nsr as nsr
from avatarcraft_tpu_torch.models import sd, toy_guidance
from avatarcraft_tpu_torch.tools import make_sbs_gif, profile_stylize_fine, sds_scale_probe, synth_gt_band_check
from avatarcraft_tpu_torch.tools import preflight_sd as preflight_sd_tool
from avatarcraft_tpu_torch.utils import gif
from avatarcraft_tpu_torch.utils.checkpoint import leaves, save_params_with_config
from avatarcraft_tpu_torch.utils.png import read_png, write_png
from test_torch_outputs import _gif_mae, _gif_props
from test_torch_preflight import _port_configs
from test_torch_tools import (
    FCFG,
    JAX_FCFG,
    JAX_TINY,
    TINY,
    _disc_set,
    _drawn,
    _field,
    _flags,
    _jax_parser,
    _last_json,
    _run_jax,
    _save_field,
)
from tests.test_sd_modules import TINY_CLIP, TINY_UNET, TINY_VAE
from tools import make_sbs_gif as jmake_sbs_gif
from tools import preflight_sd as jpreflight
from tools import profile_stylize_fine as jprofile_fine
from tools import sds_scale_probe as jsds_probe
from tools import synth_gt_band_check as jsynth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENDER_ATOL = 2e-3
PSNR_ATOL = 2e-3
SHARE_ATOL = 2e-4
GRID = os.path.join(REPO, "artifacts", "canonical", "grid.npy")
TOY_DIR = os.path.join(REPO, "artifacts", "toy_guidance")
SYNTH_ARGV = ["--view", "1", "--side", "16", "--ss_gt", "2", "--ss_eval", "2"]
FINE_STEPS = 7  # the steady rate needs two steps after the fifth
BUDGET_POSES = (22, 23)  # of the 30: the worst chunk is pose 23's second
SD_IMAGE = 32
# the UNet's context is CLIP's width
PROBE_CLIP = dataclasses.replace(TINY_CLIP, hidden_size=TINY_UNET.cross_attention_dim, num_heads=2)
POSTPROCESS_FCFG = dataclasses.replace(FCFG, hidden_dim=8, geo_feat_dim=3, num_layers_color=2, hidden_dim_color=8)


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
    """The disc set, the small field's checkpoint and an occupied 17^3 grid."""
    root = tmp_path_factory.mktemp("probes")
    f = {"root": root, "data": str(root / "disc"), "ckpt": str(root / "field.pth.tar"), "grid": str(root / "g17.npy")}
    _disc_set(f["data"])
    _save_field(_field(JAX_FCFG, 0), f["ckpt"])
    np.save(f["grid"], np.full((17,) * 3, 50.0, np.float32))
    return f


@pytest.mark.parametrize("name", ["preflight_sd", "synth_gt_band_check", "profile_stylize_fine", "make_sbs_gif"])
def test_parsers_match_jax(name):
    """Each tool's flags, defaults, choices and types are the root tool's
    (tests/test_torch_tools.py's comparison), except where the port
    differs on purpose: preflight_sd and synth_gt_band_check take
    ``--platform`` (no flag in JAX), and the band check defaults
    ``--data_path`` to reconstruct_cli's. sds_scale_probe's JAX tool reads
    ``sys.argv[1]`` without a parser (the twin's positional ``steps``)."""
    port = {"preflight_sd": preflight_sd_tool, "synth_gt_band_check": synth_gt_band_check,
            "profile_stylize_fine": profile_stylize_fine, "make_sbs_gif": make_sbs_gif}[name]
    jmain = {"preflight_sd": jpreflight.main, "synth_gt_band_check": jsynth.main,
             "profile_stylize_fine": jprofile_fine.main, "make_sbs_gif": jmake_sbs_gif.main}[name]
    got, want = _flags(port.build_parser()), _flags(_jax_parser(jmain))
    if name in ("preflight_sd", "synth_gt_band_check"):
        assert "platform" not in want
        assert got.pop("platform") == (("--platform",), "default", ["cpu", "default"], False, "_StoreAction", None)
    if name == "synth_gt_band_check":
        assert want.pop("data_path")[1].endswith("/data/smpl_da_512")
        assert got.pop("data_path")[1] == "data/smpl_da_512"
    assert got == want
    assert sds_scale_probe.build_parser().parse_args([]).steps == 2


# ---------------------------------------------------------------------------
# synth_gt_band_check
# ---------------------------------------------------------------------------


def test_synth_gt_band_check_matches_jax(inputs, tmp_path):
    """The port's tool against JAX's on one view of the disc set at side
    16: its two renders, the hard coverage, the band and the JSON."""
    argv = ["--ckpt", inputs["ckpt"], "--grid_path", inputs["grid"], "--data_path", inputs["data"]] + SYNTH_ARGV
    renders, bands = [], []
    real_jit, real_dilation = jax.jit, scipy.ndimage.binary_dilation

    def recording_jit(fn, **kw):
        jitted = real_jit(fn, **kw)

        def call(*args):
            rgb, w = jitted(*args)
            # the opacity as [N], the shape the tool was written for: JAX's
            # render_rays_fast returns [N, 1], which its w[:, None] broadcasts
            # to [N, N, 3], and the tool raises
            renders.append((np.asarray(rgb), np.asarray(w).reshape(-1)))
            return rgb, w.reshape(-1)
        return call

    def recording_dilation(mask, **kw):
        bands.append(real_dilation(mask, **kw))
        return bands[-1]

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax, "jit", recording_jit)
        m.setattr(scipy.ndimage, "binary_dilation", recording_dilation)
        want = _last_json(_run_jax(jsynth.main, argv + ["--out", str(tmp_path / "jax" / "band.json")]))
    seen = []
    with pytest.MonkeyPatch.context() as m:
        real_check = synth_gt_band_check.band_check
        m.setattr(synth_gt_band_check, "band_check", lambda *a: seen.append((a, real_check(*a))) or seen[-1][1])
        got = synth_gt_band_check.main(argv + ["--out", str(tmp_path / "port" / "band.json"), "--platform", "cpu"])
    with open(tmp_path / "port" / "band.json") as fp:
        assert json.load(fp) == got

    ((hard, soft, *_), res), = seen
    for (rgb, w), (want_rgb, want_w) in zip((hard, soft), renders):
        np.testing.assert_allclose(rgb, want_rgb, atol=RENDER_ATOL, rtol=0)
        np.testing.assert_allclose(w, want_w, atol=RENDER_ATOL, rtol=0)
    flipped = int((res["covered"] != (renders[0][1] > 0.5)).sum())
    assert flipped == 0
    assert 0 < res["covered"].mean() < 1  # the view shows an edge
    np.testing.assert_array_equal(res["band"], bands[0])
    assert 0 < res["band"].mean() < 1
    for key in ("psnr_vs_synthetic_gt", "interior_psnr"):
        assert abs(got[key] - want[key]) <= PSNR_ATOL, key
    assert abs(got["band_mse_share"] - want["band_mse_share"]) <= SHARE_ATOL
    assert got["band_frac_of_pixels"] == want["band_frac_of_pixels"]
    rest = ("view", "side", "ss_gt_hard", "ss_eval_soft", "observed_against_real_gt")
    assert {k: got[k] for k in rest} == {k: want[k] for k in rest} and set(got) == set(want)


# ---------------------------------------------------------------------------
# profile_stylize_fine
# ---------------------------------------------------------------------------


class _StubTrainer:
    """The trainer's surface the tool reads (its grid and budget), with a
    ``train`` that only calls ``on_step``: the budget and the occupancy
    come before any step."""

    def __init__(self, cfg, fcfg, guidance, params_style=None, params_gt=None, grid=None, fast_cfg=None):
        self.grid, self.fast_cfg = grid, fast_cfg

    def train(self, max_steps, on_step=None):
        for step in range(max_steps):
            on_step(step, self)
        return max_steps


def _numpy_toy_init(m):
    """JAX's toy-guidance loader restores the committed orbax directory
    into a like-tree from the eager init, which compiles op by op (about
    20 s here): the like-tree is drawn in numpy from its shapes instead
    (its values are replaced by the restore)."""
    real = jtoy.init_toy_params
    m.setattr(jtoy, "init_toy_params",
              lambda key, cfg: _drawn(jax.eval_shape(lambda k: real(k, cfg), key), np.random.default_rng(0)))


def _fine_timings_apart(result: dict) -> tuple[dict, dict]:
    timings = ("steps_per_sec", "first_step_s")
    return {k: v for k, v in result.items() if k not in timings}, {k: result[k] for k in timings}


def _pose_subset(style_360_path):
    """style_360_path's 20-pose draw (30 poses with the head views), cut
    to BUDGET_POSES after the draw, so the kept poses are the tool's."""
    def drawn(*args, **kwargs):
        poses, descs = style_360_path(*args, **kwargs)
        return [poses[i] for i in BUDGET_POSES], [descs[i] for i in BUDGET_POSES]
    return drawn


def _jax_rays(h, w, pose, device):
    """JAX's pose2rays, carried to torch."""
    return tuple(torch.from_numpy(np.array(x)).to(device) for x in jcameras.pose2rays(h, w, pose))


def test_profile_stylize_fine_budget_matches_jax(inputs, capsys):
    """At the tool's defaults (batch 32,768 on the 256x256 frame, the
    committed grid and toy guidance), on BUDGET_POSES of the tool's poses
    (the worst chunk among them) and JAX's rays: the derived budget, the
    occupancy before and after and every other key of the JSON exactly
    JAX's (the trainer stubbed on both sides). From its own rays the
    port's worst chunk is within one sample of JAX's: the 3x3 camera
    product rounds differently in XLA and torch, by one ulp in a few
    elements, which moves one probe across a cell face."""
    argv = ["--weights_path", inputs["ckpt"], "--grid_path", GRID, "--toy_weights", TOY_DIR]
    with pytest.MonkeyPatch.context() as m:
        _numpy_toy_init(m)
        m.setattr(jstylize, "StylizeTrainer", _StubTrainer)
        m.setattr(jcameras, "style_360_path", _pose_subset(jcameras.style_360_path))
        want = _last_json(_run_jax(jprofile_fine.main, argv))
        m.setattr(profile_stylize_fine, "StylizeTrainer", _StubTrainer)
        m.setattr(profile_stylize_fine, "style_360_path", _pose_subset(profile_stylize_fine.style_360_path))
        m.setattr(profile_stylize_fine, "pose2rays", _jax_rays)
        got = profile_stylize_fine.main(argv + ["--platform", "cpu"])
        assert capsys.readouterr().out.strip().splitlines()[-1] == json.dumps(got)
        assert _fine_timings_apart(got)[0] == _fine_timings_apart(want)[0]
        assert got["config"]["budget"] > 0 and 0 < got["occ_frac_start"] < 1
        m.setattr(profile_stylize_fine, "pose2rays", pose2rays)
        own, _ = profile_stylize_fine.derive_budget(256, 256, 32768, torch.as_tensor(np.load(GRID)))
    assert abs(own - got["config"]["budget"]) <= 2  # one sample of the worst chunk, times 1.1


def test_profile_stylize_fine_short_run_matches_jax_keys(inputs):
    """7 real fine steps on a 16x16 frame (StylizeConfig patched on both
    sides), batch 64, no refresh, on the small field with the committed
    toy guidance: the same JSON keys and config (the budget derived over
    that frame) as JAX's, every timing finite."""
    argv = ["--weights_path", inputs["ckpt"], "--grid_path", inputs["grid"], "--toy_weights", TOY_DIR,
            "--batch", "64", "--steps", str(FINE_STEPS), "--grid_update_every", "0"]
    with pytest.MonkeyPatch.context() as m:
        _numpy_toy_init(m)
        m.setattr(jstylize, "StylizeConfig", functools.partial(jstylize.StylizeConfig, H=16, W=16))
        want = _last_json(_run_jax(jprofile_fine.main, argv))
        m.setattr(profile_stylize_fine, "StylizeConfig",
                  functools.partial(profile_stylize_fine.StylizeConfig, H=16, W=16))
        got = profile_stylize_fine.main(argv + ["--platform", "cpu"])
    (mine, mine_t), (theirs, theirs_t) = _fine_timings_apart(got), _fine_timings_apart(want)
    assert set(got) == set(want) and mine["config"] == theirs["config"]
    assert mine["occ_frac_start"] == theirs["occ_frac_start"] and mine["compaction_still_on"]
    assert all(np.isfinite(v) and v > 0 for v in mine_t.values()), mine_t


# ---------------------------------------------------------------------------
# sds_scale_probe
# ---------------------------------------------------------------------------


def test_sds_scale_probe_counts_sd15_without_allocating():
    """The full SD 1.5 UNet's parameter count, on the meta device, exactly
    that of JAX's ``jax.eval_shape`` of its init."""
    shapes = jax.eval_shape(lambda k: jsd.init_unet_params(k, jsd.UNetConfig()), jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    tree = sd.init_unet_params(sd.MetaGenerator(), sd.UNetConfig())
    assert {t.device.type for t in leaves(tree)} == {"meta"}
    got = sds_scale_probe.count_params(tree)
    assert got == want and round(got / 1e6, 1) == round(want / 1e6, 1) == 859.6


def test_sds_scale_probe_step_matches_jax_keys():
    """One probe step at the tiny SD configs, a 32x32 guidance image, the
    small field and a 64x64 frame (one 4096-ray patch), patched on both
    sides: the same JSON keys, the same UNet count, a finite step time and
    empty memory dicts on the CPU."""
    rng = np.random.default_rng(1)
    with pytest.MonkeyPatch.context() as m:
        for name, tiny in (("UNetConfig", TINY_UNET), ("VAEConfig", TINY_VAE), ("CLIPTextConfig", PROBE_CLIP)):
            m.setattr(jsd, name, lambda tiny=tiny: tiny)
        for name in ("init_unet_params", "init_vae_encoder_params", "init_clip_text_params"):
            real = getattr(jsd, name)
            m.setattr(jsd, name, lambda key, cfg, real=real: _drawn(jax.eval_shape(lambda k: real(k, cfg), key), rng,
                                                                     0.1))
        m.setattr(jnsr, "FieldConfig", lambda **kw: JAX_FCFG)
        m.setattr(jnsr, "init_field_params", lambda key, cfg: _field(cfg, 0))
        real_modules = jdiff.GuidanceModules
        m.setattr(jdiff, "GuidanceModules", lambda **kw: real_modules(**{**kw, "image_size": SD_IMAGE}))
        want = _last_json(_run_jax(lambda argv: jsds_probe.main(steps=1, H=64, W=64), None))
    with pytest.MonkeyPatch.context() as m:
        m.setattr(sd, "stable_diffusion_configs", lambda version: _port_configs((TINY_UNET, TINY_VAE, PROBE_CLIP)))
        m.setattr(sds_scale_probe, "FieldConfig", lambda **kw: FCFG)
        m.setattr(sds_scale_probe, "SD_IMAGE_SIZE", SD_IMAGE)
        got = sds_scale_probe.main(["1", "--platform", "cpu"], H=64, W=64)
    assert set(got) == set(want) and got["unet_params_M"] == want["unet_params_M"]
    assert (got["H"], got["W"]) == (want["H"], want["W"]) == (64, 64)
    assert got["mem_after_init_GiB"] == got["mem_after_steps_GiB"] == {} == want["mem_after_steps_GiB"]
    assert np.isfinite(got["step0_s_with_compile"])


# ---------------------------------------------------------------------------
# make_sbs_gif and postprocess_multi.sh
# ---------------------------------------------------------------------------


def _frames(root, rng, n: int, shift: int):
    os.makedirs(root)
    yy, xx = np.mgrid[:12, :10]
    for i in range(n):
        img = np.stack([(xx * 20 + i * 30 + shift) % 256, (yy * 17 + shift) % 256, (xx * yy + i) % 256], -1)
        img = np.clip(img + rng.integers(-3, 4, img.shape), 0, 255).astype(np.uint8)
        write_png(os.path.join(root, f"x_body_can_{i:04d}.png"), img)
    write_png(os.path.join(root, "x_head_can_0000.png"), np.zeros((4, 4, 3), np.uint8))  # not matched


@pytest.mark.parametrize("extra", [[], ["--max_frames", "2", "--fps", "10"]])
def test_make_sbs_gif_matches_jax(tmp_path, extra):
    """Three pairs of 12x10 frames side by side: JAX's frame count, size,
    delays and loop, and the decoded frames within one level of JAX's
    error against the paired PNGs."""
    rng = np.random.default_rng(4)
    left, right = str(tmp_path / "left"), str(tmp_path / "right")
    _frames(left, rng, 3, 0)
    _frames(right, rng, 3, 90)
    argv = ["--left", left, "--right", right, "--pattern", "*_body_*.png"] + extra
    out = _run_jax(jmake_sbs_gif.main, argv + ["--out", str(tmp_path / "jax" / "sbs.gif")])
    n = make_sbs_gif.main(argv + ["--out", str(tmp_path / "port" / "sbs.gif")])
    assert out.strip().endswith(f"({n} frames)") and n == (2 if extra else 3)
    pairs = []
    for i in range(n):
        pairs.append(str(tmp_path / f"pair_{i}.png"))
        write_png(pairs[-1], np.concatenate([read_png(os.path.join(d, f"x_body_can_{i:04d}.png")) for d in (left, right)],
                                            axis=1))
    mine, ref = str(tmp_path / "port" / "sbs.gif"), str(tmp_path / "jax" / "sbs.gif")
    assert _gif_props(mine) == _gif_props(ref)
    assert gif.gif_info(mine)["delays"] == gif.gif_info(ref)["delays"] and gif.gif_info(mine)["loop"] == 0
    assert _gif_mae(mine, pairs) <= _gif_mae(ref, pairs) + 1.0
    with pytest.raises(SystemExit, match="no frame pairs"):
        make_sbs_gif.main(["--left", left, "--right", str(tmp_path), "--out", str(tmp_path / "none.gif")])


def test_postprocess_multi_runs_end_to_end(inputs, tmp_path):
    """The port's postprocess_multi.sh on the CPU (PLATFORM=cpu) at RES 16,
    TRAJ 2 and the prompt lava, in a temporary tree with the script at its
    place, small bare and styled fields with a grid, and the TINY toy
    guidance: every file the JAX script writes is there."""
    tree = tmp_path / "tree"
    script = tree / "avatarcraft_tpu_torch" / "tools" / "postprocess_multi.sh"
    os.makedirs(script.parent)
    shutil.copy(os.path.join(REPO, "avatarcraft_tpu_torch", "tools", "postprocess_multi.sh"), script)
    canonical, run = tree / "artifacts" / "canonical", tree / "style" / "toy" / "multi"
    for d in (canonical, run, tree / "docs" / "eval"):  # the repository holds docs/eval
        os.makedirs(d)
    # the bare and styled fields at 8-wide MLPs, and a 17^3 grid occupied in
    # a ball of radius 4 cells (5 % of it): the render CLI evaluates every
    # sample slot of its 4096-ray chunks, so the CPU time is the MLPs'
    for seed, path in ((0, canonical / "bare_smpl_tpu.pth.tar"), (1, run / "multi_lava_final.pth.tar")):
        save_params_with_config(nsr.init_field_params(torch.Generator().manual_seed(seed), POSTPROCESS_FCFG),
                                str(path), POSTPROCESS_FCFG)
    ball = (np.indices((17,) * 3) - 8.0) ** 2
    grid = np.where(ball.sum(0) <= 16.0, 50.0, 0.5).astype(np.float32)
    np.save(canonical / "grid.npy", grid)
    np.save(run / "multi_lava_grid.npy", grid)
    jtree = _drawn(jax.eval_shape(lambda k: jtoy.init_toy_params(k, JAX_TINY), jax.random.PRNGKey(2)),
                   np.random.default_rng(2), 0.1)
    toy_guidance.save_toy_guidance(str(tree / "artifacts" / "toy_guidance"), sd.params_from_jax(jtree, "cpu"), TINY,
                                   torch.from_numpy(np.array(jtoy.style_embeddings(JAX_TINY))))
    env = {**os.environ, "RES": "16", "TRAJ": "2", "PLATFORM": "cpu", "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run(["bash", str(script), "final", "lava"], env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert "== postprocess done ==" in res.stdout
    for rel in ("demo/canonical_360/multi_bare_16/multi_bare_16_body_can_0000.png",
                "demo/canonical_360/multi_lava/multi_lava_body_can_0001.png",
                "demo/canonical_360/multi_lava/multi_lava_head_can_0001.png",
                "artifacts/styled/multi_lava_delta.npz"):
        assert os.path.isfile(tree / rel), rel
    for rel in ("docs/media/multi_lava_sbs.gif", "docs/media/multi_lava_head_sbs.gif"):
        assert len(gif.gif_info(str(tree / rel))["delays"]) >= 1, rel
    with open(tree / "docs" / "eval" / "multi_lava.json") as fp:
        assert np.isfinite(json.load(fp)["mean_style_dist"])


def _tag_as_the_script_reads_it(script: str, tag: str) -> subprocess.CompletedProcess:
    """The script's own tag block (``case "$TAG" in ... esac``) run by bash
    under its ``set -euo pipefail`` on ``tag``; stdout the tag it uses."""
    with open(script) as fp:
        text = fp.read()
    block = text[text.index('case "$TAG" in'):]
    block = block[:block.index("esac") + len("esac")]
    return subprocess.run(["bash", "-c", f'set -euo pipefail; TAG=$1; {block}; echo "$TAG"', "tag", tag],
                          capture_output=True, text=True, timeout=30)


@pytest.mark.parametrize("tag,root_reads,port_reads", [("600", "0600", "0600"), ("0600", "0384", "0600"),
                                                       ("0800", None, "0800"), ("final", "final", "final")])
def test_postprocess_multi_reads_a_numeric_tag_as_decimal(tag, root_reads, port_reads):
    """The port's script pads a numeric tag read as decimal; the root
    script's ``printf "%04d"`` reads a zero-padded tag as octal (0600 is
    0384) and stops on 0800, an invalid octal number, under set -e."""
    root = _tag_as_the_script_reads_it(os.path.join(REPO, "tools", "postprocess_multi.sh"), tag)
    port = _tag_as_the_script_reads_it(os.path.join(REPO, "avatarcraft_tpu_torch", "tools", "postprocess_multi.sh"),
                                       tag)
    assert port.returncode == 0 and port.stdout.strip() == port_reads, port.stderr
    if root_reads is None:
        assert root.returncode != 0 and "octal" in root.stderr
    else:
        assert root.returncode == 0 and root.stdout.strip() == root_reads
