"""The PyTorch port's CLIs, their fast samplers (the parity samplers, the
CLIs' defaults, are held in tests/test_torch_parity_render.py):
render_canonical_cli's fast sampler renders
the committed artifact to PNG on the CPU; render_warp_cli's fast sampler
renders a small field that the port saved, animated on the synthetic body,
from a camera of a tiny dataset written here, equal within one 8-bit level
to the JAX package's CLI (its --mesh_devices is held in
tests/test_torch_mesh.py)."""

import os

import numpy as np
import pytest

from avatarcraft_tpu_torch import bench
from avatarcraft_tpu_torch.cli import render_canonical_cli as cli

ARGS = ["--weights_path", bench.ARTIFACT_CKPT, "--grid_path", bench.ARTIFACT_GRID, "--sampler", "fast"]


@pytest.mark.skipif(not os.path.exists(bench.ARTIFACT_CKPT), reason="artifact not present")
def test_fast_sampler_over_two_ranks_writes_the_one_process_files(tmp_path):
    """--mesh_devices 2 --sampler fast on the CPU (gloo ranks): the files of
    one process (the parity sampler's case: tests/test_torch_mesh.py)."""
    from torch_mesh_ranks import cli_files_over_ranks

    cli_files_over_ranks(tmp_path, "fast")


def test_grid_path_is_required():
    """--weights_path is required; --grid_path is not (without it the grid
    is refreshed from the SDF, test_renders_with_refreshed_grid)."""
    with pytest.raises(SystemExit):
        cli.main(["--grid_path", bench.ARTIFACT_GRID])
    assert cli.build_parser().parse_args(["--weights_path", "w"]).grid_path is None


@pytest.mark.skipif(not os.path.exists(bench.ARTIFACT_CKPT), reason="artifact not present")
def test_renders_pngs_on_cpu(tmp_path):
    cli.main(ARGS + [
        "--use_cuda", "false", "--render_h", "12", "--render_w", "16", "--trajectory_resolution", "2",
        "--batch_size", "40", "--out_dir", str(tmp_path), "--exp_name", "t",
    ])
    out = tmp_path / "canonical_360" / "t"
    names = sorted(n for n in os.listdir(out) if n.endswith(".png"))
    assert names == [f"t_{p}_can_{i:04d}.png" for p in ("body", "head") for i in range(2)]
    assert sorted(set(os.listdir(out)) - set(names)) == ["t_body_can.gif", "t_head_can.gif"]
    from test_torch_guards import _read_png

    img = _read_png(str(out / names[0]))
    assert img.shape == (12, 16, 3)
    assert (img < 250).any() and (img == 255).any()  # body on a white background
    assert np.ptp(img) > 50


@pytest.mark.skipif(not os.path.exists(bench.ARTIFACT_CKPT), reason="artifact not present")
def test_renders_analytic_normals_on_cpu(tmp_path):
    """--normal_mode analytic renders (it raised before the analytic
    normals were ported), within a few levels of the fd4 frame."""
    from test_torch_guards import _read_png

    imgs = {}
    for mode in ("analytic", "fd4"):
        cli.main(ARGS + [
            "--use_cuda", "false", "--render_h", "12", "--render_w", "16", "--trajectory_resolution", "1",
            "--batch_size", "48", "--out_dir", str(tmp_path), "--exp_name", mode, "--normal_mode", mode,
        ])
        imgs[mode] = _read_png(str(tmp_path / "canonical_360" / mode / f"{mode}_body_can_0000.png")).astype(int)
    assert (imgs["analytic"] < 250).any()
    assert np.abs(imgs["analytic"] - imgs["fd4"]).mean() < 8


def test_renders_with_refreshed_grid(tmp_path, capsys):
    """Without --grid_path the CLI refreshes a 129^3 grid from the SDF of a
    small field (written here as a reference state dict with its sidecar)
    and renders its surface."""
    import dataclasses
    import json

    import torch

    from avatarcraft_tpu_torch.models import instant_nsr as nsr

    fcfg = nsr.FieldConfig(encoder="tpu_pyramid", packed_dtype="float32",
                           pyramid=nsr.PyramidSpec(grid_resolutions=(4, 8), grid_dim=2,
                                                   plane_resolutions=(17,), plane_dim=2))
    params = nsr.init_field_params(torch.Generator().manual_seed(0), fcfg)
    state = {"deviation_net.variance": params["variance"]}
    for l, layer in enumerate(params["sdf"]):
        b = layer["b"].clone()
        b[0] -= 0.8  # a closed surface of radius ~0.8 around the origin
        state.update({f"sdf_net.{l}.weight_v": layer["v"], f"sdf_net.{l}.weight_g": layer["g"][:, None],
                      f"sdf_net.{l}.bias": b if l == len(params["sdf"]) - 1 else layer["b"]})
    for l, layer in enumerate(params["color"]):
        state.update({f"color_net.{l}.weight_v": layer["v"], f"color_net.{l}.weight_g": layer["g"][:, None]})
    for i, g in enumerate(params["grids"]):
        state[f"pyramid.grids.{i}"] = g
    for i, p in enumerate(params["planes"]):
        state[f"pyramid.planes.{i}"] = p
    ckpt = str(tmp_path / "small.pth.tar")
    torch.save(state, ckpt)
    side = {**dataclasses.asdict(fcfg), "grid": dataclasses.asdict(fcfg.grid)}
    with open(ckpt + ".fieldcfg.json", "w") as fp:
        json.dump(side, fp)

    cli.main(["--weights_path", ckpt, "--sampler", "fast", "--use_cuda", "false", "--render_h", "10", "--render_w", "10",
              "--trajectory_resolution", "1", "--batch_size", "25", "--out_dir", str(tmp_path), "--exp_name", "r"])
    assert "refreshing the density grid" in capsys.readouterr().out
    from test_torch_guards import _read_png

    img = _read_png(str(tmp_path / "canonical_360" / "r" / "r_body_can_0000.png"))
    assert img.shape == (10, 10, 3) and (img < 250).any()  # the surface, not only background


WARP_ROOT_ARGS = ["--sampler", "fast", "--use_cuda", "false", "--smpl_path", "synthetic", "--render_type",
                  "interp_shape", "--max_frames", "1", "--resolution", "128", "--render_view", "0"]


@pytest.fixture
def warp_inputs(tmp_path):
    """A one-view 128x128 Blender set (camera 2.5 in front of the body,
    looking at it) and a small field saved by the port with its sidecar:
    the pyramid encoder at toy widths, f32 tables, the SDF shifted to a
    closed surface of radius ~0.3 around the origin."""
    import torch

    from avatarcraft_tpu_torch.models import instant_nsr as nsr
    from avatarcraft_tpu_torch.utils.checkpoint import save_params_with_config
    from test_torch_dataset import write_blender_set

    rng = np.random.default_rng(0)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 2.5
    write_blender_set(str(tmp_path / "set"), rng.integers(0, 256, size=(1, 128, 128, 3), dtype=np.uint8), [pose])
    fcfg = nsr.FieldConfig(encoder="tpu_pyramid", packed_dtype="float32",
                           pyramid=nsr.PyramidSpec(grid_resolutions=(4, 8), grid_dim=2, plane_resolutions=(17,),
                                                   plane_dim=2))
    params = nsr.init_field_params(torch.Generator().manual_seed(0), fcfg)
    params["sdf"][-1]["b"][0] -= 0.3
    ckpt = str(tmp_path / "small.pth.tar")
    save_params_with_config(params, ckpt, fcfg)
    return ["--weights_path", ckpt, "--data_path", str(tmp_path / "set"), "--out_dir", str(tmp_path)]


@pytest.mark.parametrize("extra,msg", [
    (["--implicit_model", "neus"], "neus is not ported yet \\(ROADMAP item 20"),
    (["--implicit_model", "nerf"], "nerf is not ported yet \\(ROADMAP item 20"),
])
def test_warp_cli_unported_options_refuse(extra, msg, tmp_path):
    from avatarcraft_tpu_torch.cli import render_warp_cli

    with pytest.raises(SystemExit, match=msg):
        render_warp_cli.main(["--weights_path", "w", "--use_cuda", "false", "--out_dir", str(tmp_path)] + extra)


def test_warp_cli_renders_pngs_on_cpu(warp_inputs, tmp_path):
    """render_warp_cli --sampler fast on the CPU writes one PNG per frame,
    the body over the white background, equal within one level to the
    JAX package's CLI on the same inputs (it reads the port's checkpoint)."""
    from avatarcraft_tpu.cli import render_warp_cli as jax_cli
    from avatarcraft_tpu_torch.cli import render_warp_cli
    from avatarcraft_tpu_torch.utils.png import read_png
    from test_torch_guards import _read_png

    render_warp_cli.main(warp_inputs + WARP_ROOT_ARGS + ["--exp_name", "w"])
    out = tmp_path / "test_views" / "w"
    assert sorted(os.listdir(out)) == ["w.gif", "w_0000.png"]
    img = _read_png(str(out / "w_0000.png"))
    assert img.shape == (128, 128, 3)
    assert (img < 250).any() and (img == 255).any()  # the body on a white background

    jax_cli.main(warp_inputs + WARP_ROOT_ARGS + ["--exp_name", "j"])
    want = read_png(str(tmp_path / "test_views" / "j" / "j_0000.png"))  # written by Pillow, with row filters
    assert np.abs(img.astype(int) - want.astype(int)).max() <= 1


def test_warp_cli_analytic_normals_on_cpu(warp_inputs, tmp_path):
    """--normal_mode analytic on the warp CLI renders the body, within a
    few levels of the fd4 frame."""
    from avatarcraft_tpu_torch.cli import render_warp_cli
    from test_torch_guards import _read_png

    imgs = {}
    for mode in ("analytic", "fd4"):
        render_warp_cli.main(warp_inputs + WARP_ROOT_ARGS + ["--exp_name", mode, "--normal_mode", mode])
        imgs[mode] = _read_png(str(tmp_path / "test_views" / mode / f"{mode}_0000.png")).astype(int)
    assert (imgs["analytic"] < 250).any()
    assert np.abs(imgs["analytic"] - imgs["fd4"]).mean() < 8
