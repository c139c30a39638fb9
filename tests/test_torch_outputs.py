"""The outputs and utilities of the PyTorch port against the JAX package, on
the CPU: the render CLIs' GIFs and the canonical CLI's ``--log_extra``
depth PNGs and camera pickles (the JAX CLIs run on the same tiny inputs),
the JET colormap against cv2, ``--encoder`` and ``--implicit_model``, the
flags of both render CLIs against the JAX CLIs', and the numpy and
profiling utilities (``utils/{gif,profiling,overlay,misc}.py``,
``load_obj``, ``occupancy_lookup``, ``pyramid_encode_unpacked``).

Tolerances:
* a GIF: imageio decodes both packages' GIFs: the same frame count, size,
  per-frame delay and loop count; the mean absolute error of the port's
  decoded frames against its PNGs at most the JAX GIF's against its own
  PNGs plus one level (the palettes differ: the port's median cut maps each
  colour to its nearest entry, PIL's is its own; a frame of at most 256
  colours is exact in both);
* the JET table: cv2's exactly, on all 256 levels;
* ``--log_extra``: each depth PNG within one level of JAX's (the depths are
  the fast render's, held to JAX's at 1e-6 elsewhere; a level is 1/255 of
  the frame's depth range), the same pixels black; JAX writes cv2's BGR
  output through imageio, which takes it as RGB, so both packages' depth
  PNGs hold red and blue swapped (a fault of the reference kept on purpose,
  ROADMAP queue 3); the pickles equal in value;
* the numpy copies (overlay, misc, load_obj) bitwise; ``occupancy_lookup``
  exactly (a nearest-cell gather); ``pyramid_encode_unpacked`` on f32
  tables within 1e-6 (tests/test_torch_grid_encoder.py's bound);
  ``StepTimer`` exactly on a scripted host clock.
"""

import dataclasses
import json
import os
import pickle
import random

import cv2
import imageio.v3 as iio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatarcraft_tpu.cli import render_canonical_cli as jax_canonical_cli
from avatarcraft_tpu.cli import render_warp_cli as jax_warp_cli
from avatarcraft_tpu.ops import grid_encoder as jge
from avatarcraft_tpu.ops import occupancy as jocc
from avatarcraft_tpu.utils import mesh_export as jmesh
from avatarcraft_tpu.utils import misc as jmisc
from avatarcraft_tpu.utils import overlay as joverlay
from avatarcraft_tpu.utils import profiling as jprof
from avatarcraft_tpu_torch import bench
from avatarcraft_tpu_torch.cli import render_canonical_cli, render_warp_cli
from avatarcraft_tpu_torch.ops import grid_encoder as ge
from avatarcraft_tpu_torch.ops import occupancy as occ
from avatarcraft_tpu_torch.utils import gif, mesh_export, misc, overlay, profiling
from avatarcraft_tpu_torch.utils.png import read_png
from test_torch_cli import WARP_ROOT_ARGS, warp_inputs  # noqa: F401  (a fixture)

CANONICAL_ARGS = ["--weights_path", bench.ARTIFACT_CKPT, "--grid_path", bench.ARTIFACT_GRID, "--sampler", "fast",
                  "--use_cuda", "false", "--render_h", "12", "--render_w", "16", "--trajectory_resolution", "3",
                  "--batch_size", "48", "--log_extra", "true"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work (tier-1 runs six
    pytest workers on the machine's cores). Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gif_frames(path: str) -> np.ndarray:
    return np.asarray(iio.imread(path, index=None))[..., :3]


def _gif_props(path: str) -> dict:
    n = len(_gif_frames(path))
    metas = [iio.immeta(path, index=i) for i in range(n)]
    return {"frames": n, "shape": _gif_frames(path).shape[1:], "duration": [m.get("duration") for m in metas],
            "loop": iio.immeta(path, index=0).get("loop")}


def _gif_mae(path: str, pngs: list) -> float:
    frames = _gif_frames(path).astype(int)
    return float(np.mean([np.abs(f - read_png(p)[..., :3].astype(int)).mean() for f, p in zip(frames, pngs)]))


def _hold_gif(mine: str, mine_pngs: list, ref: str, ref_pngs: list) -> None:
    assert _gif_props(mine) == _gif_props(ref)
    assert gif.gif_info(mine)["delays"] == gif.gif_info(ref)["delays"]
    assert gif.gif_info(mine)["loop"] == gif.gif_info(ref)["loop"] == 0
    assert _gif_mae(mine, mine_pngs) <= _gif_mae(ref, ref_pngs) + 1.0


class _WritableAsarray:
    """numpy, but ``asarray`` copies: the JAX CLI's --log_extra writes into
    ``np.asarray(out["depth"])`` (cli/render_canonical_cli.py:239-241),
    which is a read-only view of a JAX array, and raises (a fault of the
    reference, ROADMAP queue 3); the port writes into a copy."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def asarray(a, *args, **kw):
        return np.array(a, *args, **kw)


@pytest.fixture(scope="module")
def canonical_runs(tmp_path_factory):
    """Both canonical CLIs, fast sampler, on the artifact at 12x16, 3
    frames an orbit, with --log_extra: their experiment directories."""
    root = tmp_path_factory.mktemp("canonical")
    render_canonical_cli.main(CANONICAL_ARGS + ["--out_dir", str(root), "--exp_name", "t"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_canonical_cli, "np", _WritableAsarray())
        jax_canonical_cli.main(CANONICAL_ARGS + ["--out_dir", str(root), "--exp_name", "j"])
    return root / "canonical_360" / "t", root / "canonical_360" / "j"


def test_canonical_cli_gifs_match_jax(canonical_runs):
    mine, ref = canonical_runs
    for pose in ("body", "head"):
        pngs = lambda d, e: [str(d / f"{e}_{pose}_can_{i:04d}.png") for i in range(3)]  # noqa: E731
        _hold_gif(str(mine / f"t_{pose}_can.gif"), pngs(mine, "t"), str(ref / f"j_{pose}_can.gif"), pngs(ref, "j"))
    assert _gif_props(str(mine / "t_body_can.gif"))["duration"] == [60, 60, 60]  # 15 fps


def test_canonical_cli_log_extra_matches_jax(canonical_runs):
    """The depth PNGs (JAX's channel order kept: cv2's BGR written as RGB)
    within one level of JAX's, and the camera pickles equal."""
    mine, ref = canonical_runs
    for pose in ("body", "head"):
        for i in range(3):
            a = read_png(str(mine / f"t_{pose}_can_{i:04d}_depth.png")).astype(int)
            b = read_png(str(ref / f"j_{pose}_can_{i:04d}_depth.png")).astype(int)
            assert a.shape == b.shape == (12, 16, 3)
            assert np.abs(a - b).max() <= 1
            np.testing.assert_array_equal(a.sum(-1) == 0, b.sum(-1) == 0)
        for kind in ("intrinsic", "extrinsic"):
            with open(mine / f"t_{pose}_{kind}.pkl", "rb") as f:
                got = pickle.load(f)
            with open(ref / f"j_{pose}_{kind}.pkl", "rb") as f:
                want = pickle.load(f)
            assert type(got) is type(want) and np.asarray(got).dtype == np.asarray(want).dtype
            np.testing.assert_array_equal(got, want)
    assert len(pickle.load(open(mine / "t_body_extrinsic.pkl", "rb"))) == 3


def test_depth_image_keeps_jax_channel_order():
    """depth_image is JAX's recipe: the JET colours in cv2's BGR order (a
    far pixel is red in cv2's terms, stored as blue first), empty pixels
    black."""
    depth = np.array([[0.1, 1.0], [2.0, 3.0]], np.float32)[..., None]
    want = depth.copy()
    mask = want < 4e-1
    want[mask] = 0.45
    want = (want - want.min()) / max(want.max() - want.min(), 1e-8)
    want = cv2.applyColorMap((want * 255).astype(np.uint8), cv2.COLORMAP_JET)
    want[mask.repeat(3, axis=2)] = 0
    np.testing.assert_array_equal(render_canonical_cli.depth_image(depth), want)


def test_jet_colormap_equals_cv2():
    levels = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(gif.jet_colormap(levels[:, None])[:, 0],
                                  cv2.applyColorMap(levels[:, None], cv2.COLORMAP_JET)[:, 0])
    img = np.random.default_rng(0).integers(0, 256, size=(7, 9, 1), dtype=np.uint8)
    np.testing.assert_array_equal(gif.jet_colormap(img), cv2.applyColorMap(img, cv2.COLORMAP_JET))
    with pytest.raises(ValueError):
        gif.jet_colormap(img.astype(np.float32))


def test_warp_cli_gif_matches_jax(warp_inputs, tmp_path):  # noqa: F811
    """interp_shape with 2 frames: both CLIs play them forward, then back, at
    10 fps: 3 GIF frames, the middle two stored once for 200 ms, as
    imageio's writer stores equal consecutive frames."""
    args = [a if a != "1" else "2" for a in WARP_ROOT_ARGS]  # --max_frames 2
    render_warp_cli.main(warp_inputs + args + ["--exp_name", "w"])
    jax_warp_cli.main(warp_inputs + args + ["--exp_name", "j"])
    mine, ref = tmp_path / "test_views" / "w", tmp_path / "test_views" / "j"
    order = [0, 1, 0]
    _hold_gif(str(mine / "w.gif"), [str(mine / f"w_{i:04d}.png") for i in order],
              str(ref / "j.gif"), [str(ref / f"j_{i:04d}.png") for i in order])
    assert _gif_props(str(mine / "w.gif"))["duration"] == [100, 200, 100]


def _frames(kind: str) -> list:
    rng = np.random.default_rng(1)
    if kind == "one colour":
        return [np.full((5, 7, 3), 200, np.uint8)]
    if kind == "rich":  # > 256 colours a frame, each frame its own
        return [rng.integers(0, 256, (33, 40, 3), dtype=np.uint8) for _ in range(3)]
    few = [(rng.integers(0, 3, (70, 50, 3)) * 100).astype(np.uint8) for _ in range(2)]  # 27 colours, exact
    return [few[0], few[1], few[1], few[1], few[0]]  # a run of three equal frames


@pytest.mark.parametrize("kind", ["one colour", "rich", "few"])
def test_write_gif_round_trips_through_imageio(tmp_path, kind):
    """imageio (PIL) decodes the port's GIF as it decodes imageio's own GIF
    of the same frames: the frame count (equal consecutive frames stored
    once), the size, the delays (6 hundredths a frame at 15 fps, 20 for a
    run of three), loop 0; frames of at most 256 colours exactly, richer
    ones at most one level further from the frames than imageio's."""
    frames = _frames(kind)
    path, ref = str(tmp_path / "p.gif"), str(tmp_path / "r.gif")
    gif.write_gif(path, frames, fps=15)
    import imageio.v2 as iio2

    iio2.mimsave(ref, frames, duration=1000 / 15, loop=0)
    assert _gif_props(path) == _gif_props(ref)
    assert gif.gif_info(path)["delays"] == gif.gif_info(ref)["delays"]
    assert gif.gif_info(path)["delays"] == ([6, 20, 6] if kind == "few" else [6] * len(frames))
    kept = [frames[0]] + [f for a, f in zip(frames, frames[1:]) if not np.array_equal(a, f)]
    err = np.abs(_gif_frames(path).astype(int) - np.stack(kept).astype(int)).mean()
    if kind != "rich":
        assert err == 0
    assert err <= np.abs(_gif_frames(ref).astype(int) - np.stack(kept).astype(int)).mean() + 1.0
    with pytest.raises(ValueError):
        gif.write_gif(path, [frames[0], frames[0][:-1]], fps=15)


@pytest.mark.parametrize("fps", [10, 15, 24, 30])
def test_gif_delay_is_imageios(tmp_path, fps):
    import imageio.v2 as iio2

    path = str(tmp_path / "r.gif")
    frames = [np.full((4, 4, 3), v, np.uint8) for v in (0, 9, 9, 9, 0)]
    iio2.mimsave(path, frames, duration=1000 / fps, loop=0)
    assert gif.gif_info(path)["delays"] == [gif.gif_delay_cs(fps), gif.gif_delay_cs(fps, 3), gif.gif_delay_cs(fps)]


def _canonical_fcfg_seen(monkeypatch, argv):
    seen = []

    def capture(params, fcfg, *a, **kw):
        seen.append(fcfg)
        return lambda ro, rd: {"rgb": torch.zeros(ro.shape[0], 3), "depth": torch.zeros(ro.shape[0])}

    monkeypatch.setattr(render_canonical_cli, "make_fast_frame_renderer", capture)
    render_canonical_cli.main(argv)
    return seen[0]


def test_canonical_cli_encoder_overrides_the_checkpoint(monkeypatch, tmp_path):
    """--encoder replaces the checkpoint's encoder in the field config, as
    the JAX CLI's dataclasses.replace does (cli/render_canonical_cli.py:129-132)."""
    base = CANONICAL_ARGS[:-2] + ["--trajectory_resolution", "1", "--out_dir", str(tmp_path)]
    loaded = _canonical_fcfg_seen(monkeypatch, base + ["--exp_name", "a"])
    assert loaded.encoder == "tpu_pyramid"
    assert _canonical_fcfg_seen(monkeypatch, base + ["--exp_name", "b", "--encoder", "tpu_pyramid"]) == loaded
    assert _canonical_fcfg_seen(monkeypatch, base + ["--exp_name", "c", "--encoder", "hashgrid"]) == \
        dataclasses.replace(loaded, encoder="hashgrid")


@pytest.mark.parametrize("model", ["neus", "nerf"])
def test_canonical_cli_refuses_legacy_models(tmp_path, monkeypatch, model):
    """--implicit_model neus|nerf, refused before the legacy models were
    ported, now renders as the JAX CLI does (cli/render_canonical_cli.py:
    79-127): both CLIs read one orbax checkpoint the JAX package wrote (the
    port through its own reader) and write PNGs within one level of each
    other. The models run at narrow widths, each CLI's config patched
    (NeuS 4 x 32, NeRF 3 x 32 with the default "rotate" mapping)."""
    from avatarcraft_tpu.models import nerf as jnerf
    from avatarcraft_tpu.models import neus as jneus
    from avatarcraft_tpu.utils.checkpoint import save_checkpoint
    from avatarcraft_tpu_torch.models import nerf, neus

    neus_kw = dict(d_hidden=32, n_layers=4, skip_layer=2, d_feature=32)
    nerf_kw = dict(depth=3, width=32, skip_layer=1, multires=6)
    jneus_cls, jnerf_cls = jneus.NeuSConfig, jnerf.NeRFConfig
    monkeypatch.setattr(render_canonical_cli, "NeuSConfig", lambda: neus.NeuSConfig(**neus_kw))
    monkeypatch.setattr(render_canonical_cli, "NeRFConfig", lambda mapping: nerf.NeRFConfig(mapping=mapping, **nerf_kw))
    monkeypatch.setattr(jneus, "NeuSConfig", lambda: jneus_cls(**neus_kw))
    monkeypatch.setattr(jnerf, "NeRFConfig", lambda mapping: jnerf_cls(mapping=mapping, **nerf_kw))
    if model == "neus":
        tree = jneus.init_neus_params(jax.random.PRNGKey(0), jneus_cls(**neus_kw))
    else:
        tree = jnerf.init_nerf_params(jax.random.PRNGKey(0), jnerf_cls(mapping="rotate", **nerf_kw))
    weights = str(tmp_path / "weights")
    save_checkpoint(weights, jax.device_get(tree))
    argv = ["--weights_path", weights, "--implicit_model", model, "--use_cuda", "false", "--render_h", "8",
            "--render_w", "10", "--trajectory_resolution", "2", "--batch_size", "40", "--out_dir", str(tmp_path)]
    render_canonical_cli.main(argv + ["--exp_name", "t"])
    jax_canonical_cli.main(argv + ["--exp_name", "j"])
    for orbit in ("body", "head"):
        for i in range(2):
            got = read_png(str(tmp_path / "canonical_360" / "t" / f"t_{orbit}_can_{i:04d}.png")).astype(int)
            want = read_png(str(tmp_path / "canonical_360" / "j" / f"j_{orbit}_can_{i:04d}.png")).astype(int)
            assert got.shape == want.shape == (8, 10, 3)
            assert np.abs(got - want).max() <= 1, (orbit, i)
            assert got.std() > 0  # the field shows in the frame


@pytest.mark.parametrize("port,jax_cli", [(render_canonical_cli, jax_canonical_cli),
                                          (render_warp_cli, jax_warp_cli)])
def test_render_cli_flags_cover_jax(port, jax_cli):
    """Every flag of the JAX CLI exists in the port with its default and
    choices (the port adds --normal_mode to the warp CLI), so a JAX command
    line parses; --weights_path stays required when the CLI runs."""
    def flags(parser):
        return {a.dest: (a.default, tuple(a.choices) if a.choices else None) for a in parser._actions
                if a.dest != "help"}

    want, got = flags(jax_cli.build_parser()), flags(port.build_parser())
    assert {k: got.get(k) for k in want} == want
    assert set(got) - set(want) <= {"normal_mode"}
    with pytest.raises(SystemExit):
        port.main(["--use_cuda", "false"])


def test_step_timer_matches_jax(monkeypatch):
    """The skip of the warm-up steps, the per-step seconds, the EMA and the
    rate on the same scripted host clock."""
    ticks = [0.0, 1.5, 2.0, 2.25, 3.0, 3.125, 4.0, 4.5]

    def run(mod):
        clock = iter(ticks)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        t = mod.StepTimer(skip=1, ema=0.9)
        out = []
        for _ in range(4):
            t.start()
            out.append(t.stop(sync_value=torch.tensor(1.0) if mod is profiling else jnp.float32(1.0)))
        return out, t.avg, t.rate(1600)

    assert run(profiling) == run(jprof)
    assert profiling.StepTimer(device="cpu").cuda is False and profiling.StepTimer(device="cuda").cuda is True


def test_trace_annotate_and_metrics_logger(tmp_path):
    """trace writes a Chrome / TensorBoard trace that holds the annotated
    range; the JSONL stream holds JAX's records, times aside."""
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        with profiling.annotate("outputs.step"):
            torch.ones(8).sum()
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(os.path.join(logdir, files[0])) as fp:
        events = json.load(fp)["traceEvents"]
    assert any(e.get("name") == "outputs.step" for e in events)
    with profiling.trace(str(tmp_path / "off"), enabled=False) as prof:
        assert prof is None
    assert not os.path.exists(tmp_path / "off")

    recs = {}
    for name, mod in (("port", profiling), ("jax", jprof)):
        path = str(tmp_path / name / "m.jsonl")
        log = mod.MetricsLogger(path)
        log.log(0, loss=0.5, rays_per_sec=1.0e5)
        log.log(1, psnr=30.0)
        log.close()
        with open(path) as fp:
            recs[name] = [{k: v for k, v in json.loads(line).items() if k != "time"} for line in fp]
    assert recs["port"] == recs["jax"] == [{"step": 0, "loss": 0.5, "rays_per_sec": 1.0e5}, {"step": 1, "psnr": 30.0}]
    assert profiling.MetricsLogger(None).log(3, x=1)["x"] == 1


def _mesh():
    """A closed octahedron around the origin with one face wound the other
    way, and a camera 3 units out on +z looking at it."""
    verts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]], np.float64) * 0.8
    faces = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [4, 3, 0], [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]])
    c2w = np.eye(4)
    c2w[2, 3] = 3.0
    K = np.array([[40.0, 0, 16], [0, 40.0, 12], [0, 0, 1]])
    return verts, faces, c2w, K


def test_overlay_matches_jax():
    verts, faces, c2w, K = _mesh()
    for a, b in zip(overlay.rasterize_mesh(verts, faces, c2w, K, 24, 32),
                    joverlay.rasterize_mesh(verts, faces, c2w, K, 24, 32)):
        np.testing.assert_array_equal(a, b)
    shaded = overlay.phong_render_mesh(verts, faces, c2w, K, 24, 32)
    np.testing.assert_array_equal(shaded, joverlay.phong_render_mesh(verts, faces, c2w, K, 24, 32))
    assert shaded[..., 3].sum() > 20 and shaded[..., 3].mean() < 1.0  # the mesh covers part of the frame
    img = np.random.default_rng(0).integers(0, 256, (24, 32, 3), dtype=np.uint8)
    for base in (img, img / 255.0):
        np.testing.assert_array_equal(overlay.overlay_mesh(base, verts, faces, c2w, K),
                                      joverlay.overlay_mesh(base, verts, faces, c2w, K))


def test_misc_matches_jax(tmp_path, capsys):
    def draws(mod):
        gen = mod.fix_randomness(7)
        return random.random(), np.random.rand(), gen.uniform()

    assert draws(misc) == draws(jmisc)
    misc.fix_randomness(7)
    a = torch.rand(3)
    torch.manual_seed(7)
    assert torch.equal(a, torch.rand(3))  # torch's global generator seeded too

    verts = np.random.default_rng(3).normal(size=(50, 3)) * np.array([0.2, 1.0, 0.3])
    for got, want in zip(misc.smpl_verts_to_center_and_up(verts), jmisc.smpl_verts_to_center_and_up(verts)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

    for content in ("one line", ["a", "b"]):
        misc.print_notification(content, "T")
        mine = capsys.readouterr().out
        jmisc.print_notification(content, "T")
        assert mine == capsys.readouterr().out

    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    for obj in (x, {"k": [1, 2]}):
        misc.dump_tensor(obj, str(tmp_path / "p" / "a.pkl"))
        jmisc.dump_tensor(obj, str(tmp_path / "j" / "a.pkl"))
        assert open(tmp_path / "p" / "a.pkl", "rb").read() == open(tmp_path / "j" / "a.pkl", "rb").read()
    misc.dump_tensor(torch.from_numpy(x), str(tmp_path / "t.pkl"))  # a tensor goes as its numpy array
    jmisc.dump_tensor(jnp.asarray(x), str(tmp_path / "j.pkl"))
    assert open(tmp_path / "t.pkl", "rb").read() == open(tmp_path / "j.pkl", "rb").read()

    def twice(v):
        return 2 * v

    assert misc.log_exec(twice)(4) == 8 and misc.log_exec(twice).__name__ == "twice"
    assert capsys.readouterr().out.startswith("[log_exec] test_misc_matches_jax.<locals>.twice: ")


def test_load_obj_matches_jax(tmp_path):
    path = str(tmp_path / "m.obj")
    with open(path, "w") as fp:
        fp.write("# a quad\nv 0 0 0\nv 1 0 0\nv 1 1 0.5\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 1 1\n"
                 "f 1/1 2/2 3/3\nf 1//1 3//3 4//1 2\nvn 0 0 1\n")
    got, want = mesh_export.load_obj(path), jmesh.load_obj(path)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[2], [[0, 1, 2], [0, 2, 3]])
    with open(path, "w") as fp:
        fp.write("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    assert mesh_export.load_obj(path)[1] is None and jmesh.load_obj(path)[1] is None


def test_occupancy_lookup_matches_jax(rng):
    grid = rng.uniform(0, 10, size=(17, 17, 17)).astype(np.float32)
    pts = rng.uniform(-1.9, 1.9, size=(4, 500, 3)).astype(np.float32)  # some outside the bound
    want = np.asarray(jax.jit(lambda g, p: jocc.occupancy_lookup(g, p, 1.6))(grid, pts))
    got = occ.occupancy_lookup(torch.from_numpy(grid), torch.from_numpy(pts), 1.6)
    assert got.shape == (4, 500)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pyramid_encode_unpacked_matches_jax(rng):
    kw = dict(grid_resolutions=(8, 16), grid_dim=2, plane_resolutions=(33,), plane_dim=2)
    params = {"grids": [rng.normal(size=(r, r, r, 2)).astype(np.float32) * 1e-2 for r in kw["grid_resolutions"]],
              "planes": [rng.normal(size=(3, r, r, 2)).astype(np.float32) * 1e-2 for r in kw["plane_resolutions"]]}
    x = rng.uniform(-1.7, 1.7, size=(2, 300, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: jge.pyramid_encode_unpacked(p, x, jge.PyramidSpec(**kw), size=1.6))(params, x)
    tparams = {k: [torch.from_numpy(a) for a in v] for k, v in params.items()}
    got = ge.pyramid_encode_unpacked(tparams, torch.from_numpy(x), ge.PyramidSpec(**kw), size=1.6)
    assert got.shape == (2, 300, ge.PyramidSpec(**kw).output_dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
