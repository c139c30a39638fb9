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
    with pytest.raises(SystemExit):
        cli.main(["--weights_path", bench.ARTIFACT_CKPT])


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
