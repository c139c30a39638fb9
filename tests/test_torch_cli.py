"""render_canonical_cli of the PyTorch port: the fast sampler renders the
committed artifact to PNG on the CPU; what is not ported yet refuses with a
message that says so."""

import os

import numpy as np
import pytest

from avatarcraft_tpu_torch import bench
from avatarcraft_tpu_torch.cli import render_canonical_cli as cli

ARGS = ["--weights_path", bench.ARTIFACT_CKPT, "--grid_path", bench.ARTIFACT_GRID]


@pytest.mark.parametrize(
    "extra,msg",
    [(["--sampler", "parity"], "parity is not ported"), (["--mesh_devices", "2"], "mesh_devices > 1 is not ported")],
)
def test_unported_options_refuse(extra, msg, tmp_path):
    with pytest.raises(SystemExit, match=msg):
        cli.main(ARGS + extra + ["--out_dir", str(tmp_path), "--use_cuda", "false"])


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
    names = sorted(os.listdir(out))
    assert names == [f"t_{p}_can_{i:04d}.png" for p in ("body", "head") for i in range(2)]
    from test_torch_guards import _read_png

    img = _read_png(str(out / names[0]))
    assert img.shape == (12, 16, 3)
    assert (img < 250).any() and (img == 255).any()  # body on a white background
    assert np.ptp(img) > 50


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

    cli.main(["--weights_path", ckpt, "--use_cuda", "false", "--render_h", "10", "--render_w", "10",
              "--trajectory_resolution", "1", "--batch_size", "25", "--out_dir", str(tmp_path), "--exp_name", "r"])
    assert "refreshing the density grid" in capsys.readouterr().out
    from test_torch_guards import _read_png

    img = _read_png(str(tmp_path / "canonical_360" / "r" / "r_body_can_0000.png"))
    assert img.shape == (10, 10, 3) and (img < 250).any()  # the surface, not only background
