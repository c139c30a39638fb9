"""Guards for what the card's machine needs of the PyTorch port: it imports
without JAX, the JAX package, imageio or cv2; chip_smoke.py fails loudly
without a card or without the package; kernels build for sm_90a into a
directory git ignores; the wrapper never falls back to the CPU."""

import os
import re
import shutil
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import avatarcraft_tpu_torch
from avatarcraft_tpu_torch import bench
from avatarcraft_tpu_torch.parallel import ring
from avatarcraft_tpu_torch.utils import cuda_build
from avatarcraft_tpu_torch.utils.png import integerify_img, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(avatarcraft_tpu_torch.__file__))
BLOCKED = ("jax", "jaxlib", "imageio", "cv2", "avatarcraft_tpu")
KERNELS = (ring.KERNEL, ring.RS_KERNEL)
# modules of the training slice, which the import guard must reach
TRAIN_MODULES = (
    "avatarcraft_tpu_torch.ops.sampling",
    "avatarcraft_tpu_torch.ops.occupancy",
    "avatarcraft_tpu_torch.parallel.table_mp",
    "avatarcraft_tpu_torch.workloads.reconstruct",
    "avatarcraft_tpu_torch.profile_train",
)


def _env_without_repo():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_imports_without_jax_imageio_cv2():
    code = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of these now raises ImportError
sys.path.insert(0, {REPO!r})
import avatarcraft_tpu_torch
for m in pkgutil.walk_packages(avatarcraft_tpu_torch.__path__, "avatarcraft_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
missing = [m for m in {TRAIN_MODULES!r} if m not in sys.modules]
print("imports ok" if not missing else f"not imported: {{missing}}")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=REPO, env=_env_without_repo())
    assert res.returncode == 0, res.stderr
    assert "imports ok" in res.stdout


def _port_sources():
    for root, _, files in os.walk(PKG):
        if "_build" in root or "__pycache__" in root:
            continue
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(root, f)


def test_port_never_names_the_jax_package():
    sources = list(_port_sources())
    assert len(sources) > 15
    for path in sources:
        with open(path) as fp:
            text = fp.read()
        assert not re.search(r"avatarcraft_tpu(?!_torch)", text), path
        assert not re.search(r"^\s*(import|from)\s+(jax|imageio|cv2)\b", text, re.M), path


def test_chip_smoke_without_card_fails():
    res = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True, timeout=120,
                         cwd=REPO, env=_env_without_repo())
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "is_available() is false" in res.stdout + res.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True, timeout=120,
                         cwd=tmp_path, env=_env_without_repo())
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "avatarcraft_tpu_torch" in res.stderr


@pytest.mark.parametrize("name", KERNELS)
def test_nvcc_command_targets_sm90a(name):
    cmd = cuda_build.nvcc_command(name, "/x/lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "-fPIC" in cmd and "-O3" in cmd
    assert cmd[-1] == cuda_build.source_path(name) and os.path.isfile(cmd[-1])
    assert not any(part.startswith("-I") for part in cmd)  # no PyTorch headers


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_source_names_what_it_replaces(name):
    with open(cuda_build.source_path(name)) as fp:
        src = fp.read()
    assert "parallel/ring.py:27" in src and "_ring_all_gather_kernel" in src
    assert 'extern "C"' in src and "cudaGetLastError" in src
    assert f"{name}_error_string" in src
    assert "#include <torch" not in src and "#include <ATen" not in src


@pytest.mark.parametrize("wrapper,plain", [
    (ring.all_gather_rows, "all_gather_rows_plain"), (ring.reduce_scatter_rows, "reduce_scatter_rows_plain"),
])
def test_wrapper_takes_plain_version_only_on_cpu(wrapper, plain):
    """By inspection of the dispatch: the plain version is called once, as
    the body of the ``device.type == "cpu"`` branch; past it a tensor that
    is not on the CPU launches the kernel (other devices were refused by
    the checks before)."""
    import inspect

    lines = [ln.strip() for ln in inspect.getsource(wrapper).splitlines()]
    calls = [i for i, ln in enumerate(lines) if f"{plain}(" in ln]
    assert len(calls) == 1
    assert lines[calls[0] - 1] == 'if first.device.type == "cpu":'
    assert lines[calls[0]].startswith("return ")
    assert any("launch" in ln for ln in lines[calls[0] + 1 :])
    with pytest.raises(ValueError, match="cpu or cuda"):
        wrapper([torch.zeros(4, 2, device="meta")], *([2] if plain.startswith("reduce") else []))


def test_build_dir_is_ignored_by_git():
    assert cuda_build.BUILD_DIR == os.path.join(REPO, "avatarcraft_tpu_torch", "_build")
    lib = os.path.relpath(cuda_build.library_path("all_gather_rows"), REPO)
    inside = subprocess.run(["git", "rev-parse", "--is-inside-work-tree"], cwd=REPO,
                            capture_output=True, text=True, timeout=30)
    if inside.returncode == 0:
        res = subprocess.run(["git", "check-ignore", "-q", lib], cwd=REPO, timeout=30)
        assert res.returncode == 0, f"{lib} is not ignored by git"
    else:  # a checkout without git metadata: read the rule itself
        with open(os.path.join(REPO, ".gitignore")) as fp:
            assert "avatarcraft_tpu_torch/_build/" in fp.read().split()


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    if os.path.isfile(cuda_build.nvcc_path()):
        pytest.skip("nvcc is installed here; the missing-compiler path cannot be shown")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build(list(KERNELS))


def test_bench_refuses_cpu():
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.run(device="cpu")


def _read_png(path):
    with open(path, "rb") as fp:
        data = fp.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = body
        pos += 12 + n
    w, h, depth, color, *_ = struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    ch = 3 if color == 2 else 1
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + w * ch)
    assert (raw[:, 0] == 0).all() and depth == 8
    return raw[:, 1:].reshape(h, w, ch) if ch == 3 else raw[:, 1:].reshape(h, w)


@pytest.mark.parametrize("shape", [(5, 7, 3), (4, 6)])
def test_png_round_trip(tmp_path, rng, shape):
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    np.testing.assert_array_equal(_read_png(path), img)
    with pytest.raises(ValueError):
        write_png(path, img.astype(np.float32))


def test_integerify_img():
    np.testing.assert_array_equal(
        integerify_img(np.asarray([-0.5, 0.0, 0.5, 1.0, 2.0])), np.asarray([0, 0, 127, 255, 255], np.uint8)
    )
