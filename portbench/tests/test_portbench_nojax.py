"""The check that no run loads JAX or the JAX package compares the top
level of each module's name whole, and the reference imports nothing of
the program."""

from __future__ import annotations

import subprocess
import sys

from portbench import harness


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["avatarcraft_tpu_torch", "avatarcraft_tpu_torch.ops", "jaxtyping",
                                      "portbench.jobs", "flaxen"]) == []
    assert harness.forbidden_modules(["jax.numpy", "numpy"]) == ["jax"]
    assert harness.forbidden_modules(["avatarcraft_tpu.ops.grid", "jaxlib", "flax.linen"]) == [
        "avatarcraft_tpu", "flax", "jaxlib"]


def _loaded_after(code: str, root: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted(sys.modules)))"],
                         cwd=root, capture_output=True, text=True, check=True, timeout=300)
    return {name.split(".")[0] for name in out.stdout.split()}


def test_the_reference_imports_nothing_of_the_program(root):
    loaded = _loaded_after("import portbench.reference.train, portbench.reference.frames, portbench.inputs, "
                           "portbench.compare", root)
    assert "portbench" in loaded
    assert not loaded & {"avatarcraft_tpu_torch", "avatarcraft_tpu", "jax", "jaxlib", "flax"}


def test_the_harness_and_the_port_load_no_jax(root):
    loaded = _loaded_after(
        "import portbench.harness, portbench.jobs.recon_scan, portbench.jobs.anim\n"
        "import avatarcraft_tpu_torch.workloads.reconstruct, avatarcraft_tpu_torch.workloads.warp_render, "
        "avatarcraft_tpu_torch.utils.checkpoint", root)
    assert "avatarcraft_tpu_torch" in loaded
    assert not loaded & {"avatarcraft_tpu", "jax", "jaxlib", "flax"}
