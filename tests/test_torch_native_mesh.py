"""The port's native mesh extractor (``csrc/mesh_extract.cpp`` built by
g++, ``utils/native.py``) against its numpy plain version and the JAX
package's native extractor, on the CPU.

Tolerances: against the numpy plain version, the same triangle count and
the same vertex set within 1e-4 after sorting (tests/test_native_mesh.py:
22-30; the two emit vertices in other orders, the numpy version
interpolates in f64); against the JAX package's
extractor on the same field and thread count, vertices and triangles
exactly (the same source); one thread against eight, the same counts and
vertex set."""

import filecmp
import os

import numpy as np
import pytest

from avatarcraft_tpu.utils import native as jnative
from avatarcraft_tpu_torch.utils import cuda_build, native
from avatarcraft_tpu_torch.utils.marching_cubes import marching_cubes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sphere_field(res=32, radius=0.6):
    xs = np.linspace(-1, 1, res)
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    return radius - np.sqrt(gx**2 + gy**2 + gz**2)


def _noise_field(res=24):
    """A field with many small components (and surfaces on the lattice's
    faces), from a seed."""
    return np.random.default_rng(res).normal(size=(res, res, res - 3)).astype(np.float32)


def _vertex_set(v):
    """The vertices in lexicographic order (x, then y, then z)."""
    v = np.asarray(v, np.float64)
    return v[np.lexsort(v.T[::-1])]


@pytest.mark.parametrize("field", [_sphere_field(), _sphere_field(res=17, radius=0.9), _noise_field()])
def test_native_matches_numpy_and_jax(field):
    got_v, got_t = marching_cubes(field, 0.0)
    assert got_v.dtype == np.float32 and got_t.dtype == np.int32 and len(got_t) > 100
    pv, pt = marching_cubes(field, 0.0, prefer_native=False)
    assert len(got_t) == len(pt) and len(got_v) == len(pv)
    np.testing.assert_allclose(_vertex_set(got_v), _vertex_set(pv), atol=1e-4)
    jv, jt = jnative.native_marching_cubes(field, 0.0)
    np.testing.assert_array_equal(got_v, jv)
    np.testing.assert_array_equal(got_t, jt)


def test_native_iso_level_and_threads():
    field = _sphere_field(res=40)
    v1, t1 = native.native_marching_cubes(field, 0.2, n_threads=1)
    v8, t8 = native.native_marching_cubes(field, 0.2, n_threads=8)
    assert len(v1) == len(v8) and len(t1) == len(t8)
    np.testing.assert_allclose(_vertex_set(v1), _vertex_set(v8), atol=1e-4)
    world = v1 / 39 * 2.0 - 1.0
    np.testing.assert_allclose(np.linalg.norm(world, axis=1).mean(), 0.4, atol=0.01)
    edges = np.sort(np.concatenate([t1[:, [0, 1]], t1[:, [1, 2]], t1[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all()  # watertight


@pytest.mark.parametrize("shape", [(8, 8, 8), (1, 5, 5)])
def test_native_empty_field_gives_an_empty_mesh(shape):
    v, t = native.native_marching_cubes(-np.ones(shape, np.float32), 0.0)
    assert v.shape == (0, 3) and t.shape == (0, 3) and v.dtype == np.float32 and t.dtype == np.int32
    with pytest.raises(ValueError, match="3-D"):
        native.native_marching_cubes(np.zeros((4, 4)), 0.0)


def test_copied_source_is_byte_identical():
    port = cuda_build.source_path(native.LIB)
    assert port == os.path.join(REPO, "avatarcraft_tpu_torch", "csrc", "mesh_extract.cpp")
    assert filecmp.cmp(port, os.path.join(REPO, "native", "mesh_extract.cpp"), shallow=False)


def test_gxx_command_has_the_jax_package_flags():
    """g++ -O3 -shared -fPIC -std=c++17 -pthread, as the JAX package's
    utils/native.py:29-32 builds its copy, into _build/; no nvcc."""
    out = cuda_build.library_path(native.LIB)
    assert os.path.dirname(out) == cuda_build.BUILD_DIR and out.endswith(".so")
    cmd = cuda_build.build_command(native.LIB, "/x/lib.so")
    assert os.path.basename(cmd[0]) == "g++"
    assert cmd[1:] == ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", cuda_build.source_path(native.LIB),
                       "-o", "/x/lib.so"]
    assert os.path.basename(cuda_build.build_command("all_gather_rows", "/x/lib.so")[0]) == "nvcc"


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """A source g++ refuses raises with g++'s message and leaves no file in
    the build directory; marching_cubes' native route raises it too (no
    fallback to the numpy version)."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "mesh_extract.cpp").write_text("int mesh_extract_run( {\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match=r"mesh_extract: g\+\+ exit [1-9][\s\S]*error"):
        cuda_build.build([native.LIB])
    assert os.listdir(tmp_path / "build") == []
    native.get_mesh_extract_lib.cache_clear()
    cuda_build.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ exit"):
            marching_cubes(_sphere_field(res=8), 0.0)
    finally:
        native.get_mesh_extract_lib.cache_clear()
        cuda_build.load_library.cache_clear()
