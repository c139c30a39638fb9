"""The port's toy-guidance trainer (``avatarcraft_tpu_torch/tools/
train_toy_guidance.py``) against the JAX package's root
``tools/train_toy_guidance.py``, on the CPU, at small sizes: an
octahedron of tests/test_torch_tools.py's pyramid widths with f32 tables
and its refreshed 17^3 grid as the artifact, 8 orbit views (+ 2 head
views) at 16x16, a UNet of one block of width 8 with attention
(``TOY_KW``: the committed config's embedding width and length, so the
committed style embeddings apply; the two-level UNet is held to JAX in
tests/test_torch_toy_guidance.py), batch 4, 3 steps in one call with a
warmup of 1. The JAX tool's ``main`` runs once, in the module fixture
``jax_run``, with its poses, its dataset renders (the jitted group
function's outputs) and its trained parameters recorded, its UNet init
drawn in numpy through ``jax.eval_shape``; the port's tool runs with
``--platform cpu``, that init and JAX's draws injected.

Tolerances:
* the poses: bitwise (one numpy generator);
* the dataset renders (premultiplied rgb and opacity) within 2e-3 of JAX's
  (tests/test_torch_render.py's render pin);
* the warmup-cosine schedule: optax's value at every step of several
  schedules, their boundaries included, within 1e-6 relative plus two f32
  ulps of the peak (optax evaluates in f32, the port in double; its
  warmup (0 - peak) x frac + peak cancels near step 0);
* three AdamW steps from one init with JAX's draws (views, styles,
  backgrounds, the gray noise, the timesteps, the noise and the dropout,
  from jax.random with the JAX tool's keys): the loss of the call within
  1e-5 relative (tests/test_torch_guidance.py's DDPM loss bound); all but
  1% of the parameters within 1e-5 relative plus 1e-4 x lr per step of
  JAX's (Adam against optax, tests/test_torch_guidance.py's bound: torch
  applies the weight decay before Adam's update, optax adds it to the
  update), every parameter within 2 lr per step that has a learning rate
  (Adam's first steps are about lr x sign(g), and an element whose
  gradient is a near-cancelling sum, held only at 1e-4 x its leaf's
  max|g|, may step by another fraction of lr: the bound
  tests/test_torch_scan_train.py holds its parameters to);
* the written directory: TRAIN_META.json's keys and values JAX's (the
  final loss as above), the weights read back by load_toy_guidance and
  stylize_cli's guidance bitwise the trained ones.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import avatarcraft_tpu.cameras as jcameras
from avatarcraft_tpu.models import toy_guidance as jtoy
from avatarcraft_tpu_torch.cli import stylize_cli
from avatarcraft_tpu_torch.models import sd, toy_guidance
from avatarcraft_tpu_torch.tools import train_toy_guidance as ttg
from avatarcraft_tpu_torch.utils.checkpoint import leaves, load_params_with_config
from avatarcraft_tpu_torch.workloads.reconstruct import warmup_cosine_decay
from avatarcraft_tpu_torch.workloads.reconstruct import make_grid_update_fn
from test_torch_tools import FCFG, JAX_FCFG, _drawn, _field, _last_json, _port, _run_jax, _save_field
from tools import train_toy_guidance as jttg

RENDER_ATOL = 2e-3
SCHEDULE_RTOL, SCHEDULE_ULPS = 1e-6, 2
LOSS_RTOL = 1e-5
ADAM_RTOL, ADAM_LR_ATOL, ADAM_OUTLIER_SHARE = 1e-5, 1e-4, 0.01
TOY_KW = dict(block_out_channels=(8,), layers_per_block=1, attention_head_dim=2, norm_groups=4,
              attn_blocks=(True,))
RES, VIEWS, BATCH, STEPS, LR = 16, 8, 4, 3, 1e-2
_JAX_TOY_CONFIG = jtoy.ToyGuidanceConfig  # the class, before the fixture patches it
ARGV = ["--views", str(VIEWS), "--res", str(RES), "--steps", str(STEPS), "--batch", str(BATCH), "--scan", str(STEPS),
        "--warmup", "1", "--lr", str(LR), "--seed", "0"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work (tier-1 runs six
    pytest workers on the machine's cores). Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cfg(image_size):
    return _JAX_TOY_CONFIG(image_size=image_size, **TOY_KW)


def _port_cfg(image_size):
    return toy_guidance.ToyGuidanceConfig(image_size=image_size, **TOY_KW)


def _octahedron_field(radius: float = 0.8):
    """A field of JAX_FCFG whose SDF is |x|_1 - radius (six softplus units
    of the first layer read +-x, +-y, +-z; the tables are zero), so the
    style cameras see a body."""
    jp = _field(JAX_FCFG, 0)
    jp["grids"] = [np.zeros_like(g) for g in jp["grids"]]
    jp["planes"] = [np.zeros_like(p) for p in jp["planes"]]
    v0, v1 = jp["sdf"][0]["v"], jp["sdf"][1]["v"]
    v0[:6] = 0.0
    for i in range(3):
        v0[2 * i, i], v0[2 * i + 1, i] = 1.0, -1.0
    v1[0] = 0.0
    v1[0, :6] = 1.0
    for layer in jp["sdf"]:
        layer["g"] = np.linalg.norm(layer["v"], axis=1)
        layer["b"][:] = 0.0
    jp["sdf"][-1]["b"][0] = -radius
    return jp


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A small artifact directory (the octahedron field and its 17^3 grid,
    refreshed from zeros) and the UNet init both tools start from, drawn
    in numpy."""
    root = tmp_path_factory.mktemp("toy_train")
    art = str(root / "artifact")
    os.makedirs(art)
    field = _octahedron_field()
    _save_field(field, os.path.join(art, "bare_smpl_tpu.pth.tar"))
    grid = make_grid_update_fn(FCFG, 1.6)(_port(field), torch.zeros((17,) * 3))
    np.save(os.path.join(art, "grid.npy"), grid.numpy())
    rng = np.random.default_rng(11)
    init = _drawn(jax.eval_shape(lambda k: jtoy.init_toy_params(k, _jax_cfg(RES)), jax.random.PRNGKey(1)), rng, 0.1)
    return {"root": str(root), "artifact": art, "init": init}


@pytest.fixture(scope="module")
def jax_run(artifact):
    """The JAX tool's main once: its JSON, poses, group renders and trained
    parameters."""
    run = {"poses": [], "renders": [], "params": []}
    real_jit, real_path = jax.jit, jcameras.style_360_path

    def jit(fn, *a, **kw):  # records the dataset renders of the tool's jitted group function
        compiled = real_jit(fn, *a, **kw)
        if getattr(fn, "__name__", "") != "_render_group":
            return compiled

        def group(*args):
            out = compiled(*args)
            run["renders"].append(tuple(np.asarray(x) for x in out))
            return out

        return group

    def path(*a, **kw):
        out = real_path(*a, **kw)
        run["poses"].append(out[0])
        return out

    def save(out, params, cfg):
        os.makedirs(out, exist_ok=True)
        run["params"].append(jax.tree_util.tree_map(np.asarray, params))

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax, "jit", jit)
        m.setattr(jcameras, "style_360_path", path)
        m.setattr(jtoy, "ToyGuidanceConfig", _jax_cfg)
        m.setattr(jtoy, "init_toy_params", lambda key, cfg: artifact["init"])
        m.setattr(jtoy, "save_toy_guidance", save)
        run["json"] = _last_json(_run_jax(jttg.main, ["--artifact", artifact["artifact"], "--out",
                                                      os.path.join(artifact["root"], "jax_out"), "--platform",
                                                      "cpu"] + ARGV))
    return run


def _jax_draws(seed: int, n_views: int) -> list[dict]:
    """The JAX tool's draws of its first call, step by step (:151-157 and
    the DDPM loss's split of k5), as the port's ``draw_step`` returns them."""
    n_styles = len(jtoy.STYLES)
    _, sub = jax.random.split(jax.random.PRNGKey(seed + 2))
    draws = []
    for k in jax.random.split(sub, STEPS):
        k1, k2, k3, k4, k5 = jax.random.split(k, 5)
        k_t, k_n, k_d = jax.random.split(k5, 3)
        d = {"vi": jax.random.randint(k1, (BATCH,), 0, n_views), "si": jax.random.randint(k2, (BATCH,), 0, n_styles),
             "bi": jax.random.randint(k3, (BATCH,), 0, 3), "noise_b": jax.random.normal(k4, (BATCH, RES, RES, 1)),
             "t": jax.random.randint(k_t, (BATCH,), 0, 1000), "noise": jax.random.normal(k_n, (BATCH, 3, RES, RES)),
             "drop": jax.random.uniform(k_d, (BATCH,)) < 0.1}
        draws.append({name: torch.from_numpy(np.array(v).astype(np.int64 if v.dtype == jnp.int32 else v.dtype))
                      for name, v in d.items()})
    return draws


def test_dataset_poses_and_renders_match_jax(artifact, jax_run):
    """The poses bitwise; the port's group renders (one gather a group of 8
    views) within the render pin of the JAX tool's jitted groups."""
    poses = ttg.dataset_poses(VIEWS, 0.35, 0)
    (want,) = jax_run["poses"]
    assert poses.dtype == want.dtype and np.array_equal(poses, want) and len(poses) == VIEWS + 2
    params, fcfg = load_params_with_config(os.path.join(artifact["artifact"], "bare_smpl_tpu.pth.tar"), "cpu")
    grid = torch.as_tensor(np.load(os.path.join(artifact["artifact"], "grid.npy")))
    fast_cfg = ttg.FastRenderConfig(n_probes=192, k_samples=32, bound=1.6, sample_budget=RES * RES * 5,
                                    normal_mode="fd4")
    rgb, alpha = ttg.render_dataset(params, fcfg, fast_cfg, grid, poses, RES)
    assert len(jax_run["renders"]) == 2  # groups of 8 views
    jrgb = np.concatenate([r for r, _ in jax_run["renders"]]).reshape(-1, RES, RES, 3)
    jalpha = np.concatenate([a for _, a in jax_run["renders"]]).reshape(-1, RES, RES).clip(0.0, 1.0)
    assert 0.05 < float(alpha.mean()) < 0.95  # the body covers part of the frames
    np.testing.assert_allclose(rgb.numpy(), jrgb, atol=RENDER_ATOL, rtol=0)
    np.testing.assert_allclose(alpha.numpy(), jalpha, atol=RENDER_ATOL, rtol=0)


@pytest.mark.parametrize("lr,warmup,decay", [(3e-4, 200, 4000), (1e-2, 1, 3), (3e-4, 0, 7), (5e-3, 5, 6)])
def test_warmup_cosine_decay_matches_optax(lr, warmup, decay):
    """Every step from 0 to past the end, the warmup's last step, the
    boundary and decay_steps included."""
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, decay, lr * 0.05)
    got = warmup_cosine_decay(0.0, lr, warmup, decay, lr * 0.05)
    steps = np.arange(decay + 3)
    np.testing.assert_allclose([got(int(s)) for s in steps], np.asarray(jax.vmap(want)(steps)), rtol=SCHEDULE_RTOL,
                               atol=SCHEDULE_ULPS * lr * 2.0**-23)
    assert got(0) == 0.0 if warmup else got(0) == lr
    with pytest.raises(ValueError, match="must exceed"):
        warmup_cosine_decay(0.0, lr, decay, decay)


def test_train_steps_with_jax_draws_match_jax(artifact, jax_run, monkeypatch, tmp_path, capsys):
    """Three AdamW steps from JAX's init with JAX's draws injected: the
    trained parameters and the JSON (TRAIN_META.json) against JAX's; the
    directory loads through load_toy_guidance and stylize_cli's guidance,
    which gives a finite eps."""
    draws = iter(_jax_draws(0, VIEWS + 2))
    real_draw = ttg.draw_step

    def jax_draw(generator, batch, n_views, n_styles, res, device):
        mine = real_draw(generator, batch, n_views, n_styles, res, device)
        d = next(draws)
        assert {k: (v.shape, v.dtype) for k, v in mine.items()} == {k: (v.shape, v.dtype) for k, v in d.items()}
        return d

    monkeypatch.setattr(ttg, "draw_step", jax_draw)
    monkeypatch.setattr(ttg, "ToyGuidanceConfig", _port_cfg)
    monkeypatch.setattr(ttg, "init_unet_params", lambda gen, ucfg: sd.params_from_jax(artifact["init"], gen.device))
    out = str(tmp_path / "toy")
    got = ttg.main(["--artifact", artifact["artifact"], "--out", out, "--platform", "cpu"] + ARGV)
    assert next(draws, None) is None
    assert _last_json(capsys.readouterr().out) == got
    want = jax_run["json"]
    assert got.keys() == want.keys()
    assert {k: v for k, v in got.items() if k != "final_loss"} == {k: v for k, v in want.items() if k != "final_loss"}
    assert abs(got["final_loss"] - want["final_loss"]) <= LOSS_RTOL * abs(want["final_loss"])
    with open(os.path.join(out, "TRAIN_META.json")) as fp:
        assert json.load(fp) == got
    # the JAX tool's orbax params/ and config.json, and the port's npz of the style embeddings
    assert sorted(os.listdir(out)) == ["TRAIN_META.json", "config.json", "params", toy_guidance.WEIGHTS_FILE]
    with np.load(os.path.join(out, toy_guidance.WEIGHTS_FILE)) as z:
        assert z.files == ["style_embeddings"]

    params, cfg, embs = toy_guidance.load_toy_guidance(out, "cpu")
    assert cfg == _port_cfg(RES)
    (jparams,) = jax_run["params"]
    ref = sd.params_from_jax(jparams, "cpu")
    diffs, bounds = [], []
    for a, b, i in zip(leaves(params), leaves(ref), leaves(sd.params_from_jax(artifact["init"], "cpu"))):
        assert a.shape == b.shape and not torch.equal(a, i)
        diffs.append((a - b).abs().reshape(-1))
        bounds.append((ADAM_RTOL * b.abs() + ADAM_LR_ATOL * LR * STEPS).reshape(-1))
    diff, bound = torch.cat(diffs), torch.cat(bounds)
    assert float(diff.max()) <= 2 * LR * (STEPS - 1)  # the steps after the warmup's lr of 0
    assert float((diff > bound).float().mean()) <= ADAM_OUTLIER_SHARE
    np.testing.assert_array_equal(embs.numpy(), np.asarray(jtoy.style_embeddings(_jax_cfg(RES))))

    guidance = stylize_cli.build_guidance(
        stylize_cli.build_parser().parse_args(["--guidance_type", "toy", "--toy_weights", out]), "cpu")
    for a, b in zip(leaves(params), leaves(toy_guidance.load_toy_guidance(out, "cpu")[0])):
        assert torch.equal(a, b)
    lat = torch.zeros((1, 3, RES, RES))
    eps = guidance.m.unet(lat, torch.tensor([500]), guidance.m.text_encode(["lava"]))
    assert eps.shape == lat.shape and torch.isfinite(eps).all()


def test_style_embeddings_come_from_the_committed_file():
    """The committed embeddings are JAX's draw for the default config; any
    other seed, style list or shape is refused with the reason."""
    cfg = toy_guidance.ToyGuidanceConfig()
    np.testing.assert_array_equal(ttg.style_embeddings(cfg, "cpu").numpy(),
                                  np.asarray(jtoy.style_embeddings(jtoy.ToyGuidanceConfig())))
    for other in (dataclasses.replace(cfg, seed=7), dataclasses.replace(cfg, styles=("lava",)),
                  dataclasses.replace(cfg, emb_dim=8)):
        with pytest.raises(SystemExit, match="does not draw"):
            ttg.style_embeddings(other, "cpu")


def test_compose_batch_backgrounds():
    """White, black and clipped gray noise behind each sample's styled
    foreground, by its background draw."""
    styled = torch.rand((3, 2, 4, 4, 3))
    alpha = torch.rand((2, 4, 4))
    vi, si, bi = torch.tensor([1, 0, 1]), torch.tensor([2, 0, 1]), torch.tensor([0, 1, 2])
    noise_b = torch.randn((3, 4, 4, 1)) * 10
    imgs = ttg.compose_batch(styled, alpha, vi, si, bi, noise_b)
    bg = [torch.ones((4, 4, 1)), torch.zeros((4, 4, 1)), torch.clamp(0.5 + 0.1 * noise_b[2], 0.0, 1.0)]
    for i in range(3):
        want = styled[si[i], vi[i]] + bg[i] * (1.0 - alpha[vi[i]][..., None])
        assert torch.equal(imgs[i], want)
