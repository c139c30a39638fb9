"""Fixtures of the benchmark's tests: the repository's root, and the cells
at a size the CPU holds (a tiny field saved as an artifact, small frames
and batches), with the real cells' jobs, traffic and limits."""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import pytest
import torch

from portbench import harness, inputs
from portbench.jobs.base import file_sha256

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ("recon_scan.fast", "orbit.fast")

TINY_FIELD = {
    "grid": {"input_dim": 3, "num_levels": 4, "level_dim": 2, "base_resolution": 4, "log2_hashmap_size": 10,
             "desired_resolution": 32, "per_level_scale": 2.0},
    "pyramid": {"grid_resolutions": [8, 16], "grid_dim": 2, "plane_resolutions": [16, 32], "plane_dim": 2},
    "encoder": "tpu_pyramid", "packed_dtype": "bfloat16", "num_layers": 2, "hidden_dim": 16, "geo_feat_dim": 7,
    "num_layers_color": 2, "hidden_dim_color": 16, "include_input": True, "use_viewdirs": False, "sh_degree": 4,
    "variance_init": 0.3, "mlp_dtype": "float32",
}


def tiny_artifact(path: str) -> None:
    """A tiny field, written by the port as its artifacts are: the
    geometric init with a sphere of radius 0.4 as its surface, tables of a
    visible scale that the SDF reads, so that a frame shows a body and its
    tables' precision shows in it."""
    from avatarcraft_tpu_torch.utils import checkpoint

    params = inputs.field_init(11, TINY_FIELD, "cpu")
    params["sdf"][-1]["b"][0] = -0.4
    g = torch.Generator().manual_seed(3)
    params["grids"] = [torch.rand(t.shape, generator=g) * 0.2 - 0.1 for t in params["grids"]]
    params["planes"] = [torch.rand(t.shape, generator=g) * 0.2 - 0.1 for t in params["planes"]]
    params["color"] = [dict(layer, v=layer["v"] * 4.0) for layer in params["color"]]
    # the geometric init reads no encoding: give the first layer's encoding columns weight
    v = params["sdf"][0]["v"]
    params["sdf"][0]["v"] = torch.cat([v[:, :3], torch.randn(v[:, 3:].shape, generator=g) * 0.5], dim=1)
    checkpoint.save_params_with_config(params, path, checkpoint.field_config_from_dict(TINY_FIELD),
                                       table_dtype=torch.float16)


@pytest.fixture(scope="session")
def root() -> str:
    return ROOT


@pytest.fixture(scope="session")
def tiny_cells(tmp_path_factory) -> dict:
    """{cell name: Cell} at a size the CPU holds. The artifact is written
    under the repository's root (a configuration names its files relative
    to the checkout)."""
    tmp = tmp_path_factory.mktemp("portbench")
    art_dir = os.path.join(ROOT, "_tree_check_portbench_tests", os.path.basename(str(tmp)))
    os.makedirs(art_dir, exist_ok=True)
    path = os.path.join(art_dir, "tiny.pth.tar")
    tiny_artifact(path)
    grid = os.path.join(art_dir, "grid.npy")
    axis = np.linspace(-1.6, 1.6, 17)
    r = np.sqrt(sum(a**2 for a in np.meshgrid(axis, axis, axis, indexing="ij")))
    np.save(grid, np.where(r < 0.6, 100.0, 0.0).astype(np.float32))
    cells = {name: harness.find_cell(ROOT, name) for name in CELLS}
    cells["anim.fast"] = anim_cell(cells["orbit.fast"])
    out = {}
    c = copy.deepcopy(cells["recon_scan.fast"])
    c.config = dict(c.config, field=TINY_FIELD)
    c.traffic.update(views=4, res=32, batch_size=64, grid_resolution=17)
    out["recon_scan.fast"] = c
    artifact = {"file": os.path.relpath(path, ROOT), "sha256": file_sha256(path)}
    c = copy.deepcopy(cells["anim.fast"])
    c.config = dict(c.config, field=TINY_FIELD, artifact=artifact)
    c.traffic.update(res=16, chunk=64, max_frames=4, check_frames=2)
    out["anim.fast"] = c
    c = copy.deepcopy(cells["orbit.fast"])
    c.config = dict(c.config, field=TINY_FIELD, artifact=artifact)
    c.traffic.update(res=16, chunk=64, grid=os.path.relpath(grid, ROOT), grid_sha256=file_sha256(grid))
    out["orbit.fast"] = c
    return out


def anim_cell(like) -> harness.Cell:
    """The animation's cell, which BENCHMARK.json leaves out while the
    port's warp misses the closest face (PERF.md, section 7), from its
    traffic file, with ``like``'s configuration and end-to-end metrics and
    a limit for the tiny size (its readings there: the port 7.9e-4, the
    control 0.18)."""
    with open(os.path.join(ROOT, "portbench", "traffic", "anim.json")) as fp:
        traffic = json.load(fp)
    return harness.Cell(name="anim.fast", chips=1, config=like.config, traffic=traffic, limits={"image": 5e-3},
                        metrics_e2e=like.metrics_e2e, metrics_layer=[])


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip: python3 -m pytest portbench/tests -m card)")
    return torch.device("cuda", 0)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips elsewhere (decided in the `card` fixture)")
