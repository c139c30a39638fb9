"""The port's orbax reader (``utils/orbax.py``, ``utils/checkpoint.py::
load_checkpoint``) against orbax itself, on the CPU: the committed toy
guidance directory, and checkpoints the JAX package's ``save_checkpoint``
writes into ``tmp_path`` (a NeuS tree, a NeRF tree, an instant-NSR tree
with bf16 tables, a reconstruct train state with optax's Adam state and an
int step). Every leaf must have orbax's type, dtype, shape and bits; the
tree orbax's ``StandardCheckpointer().restore`` returns (without a target,
and with one). Also: B-tree nodes above the leaves and zarr arrays of
several chunks, written by tensorstore with small nodes and chunks; the
readers built on it (``safe_load_params``, ``load_train_state``,
``load_toy_guidance``); the refusals. There is no zstd decoder of the
port's own to test: the reader binds the system's libzstd.
"""

import collections
import ctypes.util
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avatarcraft_tpu.models import instant_nsr as jnsr
from avatarcraft_tpu.models import nerf as jnerf
from avatarcraft_tpu.models import neus as jneus
from avatarcraft_tpu.ops.grid_encoder import PyramidSpec as JaxPyramidSpec
from avatarcraft_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from avatarcraft_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from avatarcraft_tpu.workloads import reconstruct as jrecon
from avatarcraft_tpu_torch.models import toy_guidance
from avatarcraft_tpu_torch.utils import checkpoint as ckpt
from avatarcraft_tpu_torch.utils import orbax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY_DIR = os.path.join(REPO, "artifacts", "toy_guidance")


def _bits(a):
    """(dtype name, shape, bytes) of a leaf of either reader."""
    if isinstance(a, torch.Tensor):
        return str(a.dtype).replace("torch.", ""), tuple(a.shape), a.view(torch.int16).numpy().tobytes()
    a = np.asarray(a)
    return str(a.dtype), a.shape, a.tobytes()


def assert_same_tree(got, want, path="tree"):
    """``got`` (the port's reader) is ``want`` (orbax's): the same
    containers, Python scalars of the same type and value, array leaves of
    the same dtype, shape and bits (jax.Array leaves come back as numpy
    arrays, bfloat16 ones as torch tensors)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}/{i}")
    elif want is None or isinstance(want, (bool, int, float)):
        assert type(got) is type(want) and got == want, (path, got, want)
    else:
        assert isinstance(got, (np.ndarray, torch.Tensor)), (path, type(got))
        assert _bits(got) == _bits(want), path


def test_committed_toy_checkpoint_bitwise():
    """The committed OCDBT directory: orbax's tree bitwise, and every leaf
    bitwise the committed params_torch.npz (its keys the tree's joined by
    "/")."""
    path = os.path.join(TOY_DIR, "params")
    got = ckpt.load_checkpoint(path)
    assert_same_tree(got, jax_load_checkpoint(path))
    flat = {}

    def walk(node, key):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{key}/{k}")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{key}/{i}")
        elif node is not None:
            flat[key[1:]] = node

    walk(got, "")
    with np.load(os.path.join(TOY_DIR, toy_guidance.WEIGHTS_FILE)) as z:
        names = sorted(k for k in z.files if k.startswith("params/"))
        assert sorted(flat) == names and len(names) == 368
        for k in names:
            assert _bits(flat[k]) == _bits(z[k]), k


def test_toy_guidance_loads_through_the_reader(tmp_path):
    """load_toy_guidance reads params/ through the reader; the tree equals
    the one of a copy of the directory without params/, which reads the
    npz (as a directory save_toy_guidance wrote)."""
    params, cfg, embs = toy_guidance.load_toy_guidance(TOY_DIR, device="cpu")
    for f in ("config.json", toy_guidance.WEIGHTS_FILE):
        shutil.copy(os.path.join(TOY_DIR, f), tmp_path)
    ref, rcfg, rembs = toy_guidance.load_toy_guidance(str(tmp_path), device="cpu")
    assert cfg == rcfg and torch.equal(embs, rembs)
    gl, rl = ckpt.sorted_leaves(params), ckpt.sorted_leaves(ref)
    assert len(gl) == len(rl) == 368 and all(torch.equal(a, b) for a, b in zip(gl, rl))
    assert jax.tree_util.tree_structure(ckpt.map_leaves(params, lambda t: 0)) == \
        jax.tree_util.tree_structure(ckpt.map_leaves(ref, lambda t: 0))


def _neus_tree():
    cfg = jneus.NeuSConfig(d_hidden=32, n_layers=4, skip_layer=2, d_feature=32)
    return jax.device_get(jneus.init_neus_params(jax.random.PRNGKey(0), cfg))


def _nerf_tree():
    cfg = jnerf.NeRFConfig(depth=4, width=32, skip_layer=2, mapping="rotate")
    return jax.device_get(jnerf.init_nerf_params(jax.random.PRNGKey(1), cfg))


def _nsr_bf16_tree():
    """An instant-NSR pyramid tree, its tables stored as bf16 (jax.Array
    leaves) and its MLP as numpy f32 (np.ndarray leaves)."""
    fcfg = jnsr.FieldConfig(encoder="tpu_pyramid", pyramid=JaxPyramidSpec(
        grid_resolutions=(4, 8), grid_dim=2, plane_resolutions=(17,), plane_dim=2))
    tree = jax.tree_util.tree_map(np.asarray, jnsr.init_field_params(jax.random.PRNGKey(2), fcfg))
    rng = np.random.default_rng(0)
    for key in ("grids", "planes"):
        tree[key] = [jnp.asarray(rng.normal(size=t.shape), jnp.bfloat16) for t in tree[key]]
    return tree


def _train_state_tree():
    """A reconstruct train state as train_fast saves it
    (workloads/reconstruct.py:445-456): params, optax Adam's chain state
    after two updates, the grid, and an int step."""
    params = _nerf_tree()
    tx = jrecon.make_optimizer(jrecon.ReconstructConfig(), 10)
    opt_state = tx.init(params)
    rng = np.random.default_rng(3)
    for _ in range(2):
        g = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
    return {"params": jax.device_get(params), "opt_state": jax.device_get(opt_state),
            "grid": rng.uniform(0, 100, size=(9, 9, 9)).astype(np.float32), "step": 2}


TREES = {"neus": _neus_tree, "nerf": _nerf_tree, "nsr_bf16": _nsr_bf16_tree, "train_state": _train_state_tree}


@pytest.mark.parametrize("name", sorted(TREES))
def test_reader_matches_orbax_restore(tmp_path, name):
    path = str(tmp_path / name)
    tree = TREES[name]()
    jax_save_checkpoint(path, tree)
    want = jax_load_checkpoint(path)
    got = ckpt.load_checkpoint(path)
    assert_same_tree(got, want)
    # with a target: its structure (tuples, named tuples), looked up by key path
    like = jax.tree_util.tree_map(np.asarray, tree)
    want_like = jax_load_checkpoint(path, like)
    got_like = ckpt.load_checkpoint(path, like)
    assert jax.tree_util.tree_structure(got_like) == jax.tree_util.tree_structure(want_like)
    for g, w in zip(jax.tree_util.tree_leaves(got_like), jax.tree_util.tree_leaves(want_like)):
        assert _bits(g) == _bits(w)


def test_legacy_and_field_readers(tmp_path):
    """safe_load_params and the legacy carriers read the JAX package's
    orbax directories as f32 tensors on the device asked for (bf16 tables
    widened exactly); a tree of the wrong model is refused."""
    tree = _nsr_bf16_tree()
    jax_save_checkpoint(str(tmp_path / "nsr"), tree)
    got = ckpt.safe_load_params(str(tmp_path / "nsr"), device="cpu")
    for g, w in zip(ckpt.sorted_leaves(got), jax.tree_util.tree_leaves(tree)):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w, np.float32))
    jax_save_checkpoint(str(tmp_path / "neus"), _neus_tree())
    neus = ckpt.neus_params_from_jax(ckpt.load_checkpoint(str(tmp_path / "neus")), "cpu")
    assert len(neus["sdf"]) == 4 and neus["variance"].shape == ()
    with pytest.raises(ValueError, match="not a NeRF parameter tree"):
        ckpt.nerf_params_from_jax(ckpt.load_checkpoint(str(tmp_path / "neus")), "cpu")


def test_load_train_state_reads_the_jax_state(tmp_path):
    """A JAX train-state directory loads as train_state_from_optax's file
    of the same state: parameters, Adam's moments and count, step, grid."""
    tree = _train_state_tree()
    jax_save_checkpoint(str(tmp_path / "state"), tree)
    got = ckpt.load_train_state(str(tmp_path / "state"), "cpu")
    adam = tree["opt_state"][0]
    ckpt.train_state_from_optax(str(tmp_path / "carried.pt"), tree["params"], adam.mu, adam.nu, int(adam.count),
                                tree["step"], tree["grid"])
    want = ckpt.load_train_state(str(tmp_path / "carried.pt"), "cpu")
    assert got["count"] == want["count"] == 2 and got["step"] == want["step"] == 2
    assert torch.equal(got["grid"], want["grid"])
    for key in ("params", "mu", "nu"):
        gl, wl = ckpt.sorted_leaves(got[key]), ckpt.sorted_leaves(want[key])
        assert len(gl) == len(wl) > 0 and all(torch.equal(a, b) for a, b in zip(gl, wl)), key


def test_ocdbt_interior_nodes_and_chunked_arrays(tmp_path):
    """Tensorstore's OCDBT with 600-byte nodes (a B-tree several levels
    deep) and 16-byte inline values, holding zarr v2 arrays of several
    chunks with partial edge chunks, and missing chunks (the fill value,
    null or a bfloat16 1.5): every key and every array as tensorstore
    reads them."""
    ts = pytest.importorskip("tensorstore")
    base = {"driver": "ocdbt", "base": f"file://{tmp_path}/kv",
            "config": {"max_decoded_node_bytes": 600, "max_inline_value_bytes": 16}}
    rng = np.random.default_rng(0)
    arrays = {"a.f32": rng.normal(size=(37, 11)).astype(np.float32), "b.i32": rng.integers(-9, 9, (5, 6, 7)),
              "c.bf16": rng.normal(size=(9, 4)).astype(np.float32)}
    chunks = {"a.f32": [8, 4], "b.i32": [2, 6, 3], "c.bf16": [4, 4]}
    dtypes = {"a.f32": "float32", "b.i32": "int32", "c.bf16": "bfloat16"}
    for name, a in arrays.items():
        t = ts.open({"driver": "zarr", "kvstore": {**base, "path": name + "/"},
                     "metadata": {"chunks": chunks[name], "shape": list(a.shape),
                                  "compressor": {"id": "zstd", "level": 1}},
                     "create": True, "dtype": dtypes[name]}).result()
        t.write(a.astype(t.dtype.numpy_dtype)).result()
    kv = ts.KvStore.open({k: v for k, v in base.items() if k != "config"}).result()
    with ts.Transaction() as txn:
        for i in range(300):
            kv.with_transaction(txn)[f"k{i % 7}/{i:05d}"] = b"v%d" % i * (1 + i % 9)
    store = orbax.read_ocdbt(str(tmp_path / "kv"))
    keys = kv.list().result()
    assert sorted(store) == sorted(k.decode() for k in keys) and len(keys) > 300
    for k in keys:
        assert store[k.decode()] == kv.read(k).result().value, k
    for name in arrays:
        want = ts.open({"driver": "zarr", "kvstore": {**base, "path": name + "/"}}).result().read().result()
        assert _bits(orbax.read_zarr_array(store, name)) == _bits(want), name
    # a missing chunk reads as the fill value (zero for null)
    del store["a.f32/0.0"]
    got = orbax.read_zarr_array(store, "a.f32")
    assert not got[:8, :4].any() and np.array_equal(got[8:], arrays["a.f32"][8:])
    # a bfloat16 array's fill value, where a chunk was never written
    t = ts.open({"driver": "zarr", "kvstore": {**base, "path": "d.bf16/"}, "create": True,
                 "metadata": {"chunks": [2, 2], "shape": [4, 4], "dtype": "bfloat16", "fill_value": 1.5,
                              "compressor": {"id": "zstd", "level": 1}}}).result()
    t[:2, :2].write(np.full((2, 2), -2.0, t.dtype.numpy_dtype)).result()
    want = ts.open({"driver": "zarr", "kvstore": {**base, "path": "d.bf16/"}}).result().read().result()
    assert _bits(orbax.read_zarr_array(orbax.read_ocdbt(str(tmp_path / "kv")), "d.bf16")) == _bits(want)


def test_reader_refusals(tmp_path, monkeypatch):
    """A missing libzstd raises (there is no other zstd route); a corrupt
    manifest, another handler's directory and a leaf type the reader does
    not know raise and name the cause."""
    path = str(tmp_path / "c")
    jax_save_checkpoint(path, {"w": np.ones(3, np.float32)})
    orbax.libzstd.cache_clear()
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    try:
        with pytest.raises(RuntimeError, match="libzstd"):
            ckpt.load_checkpoint(path)
    finally:
        monkeypatch.undo()
        orbax.libzstd.cache_clear()
    assert "zstd" in orbax.zstd_route()
    data = bytearray(open(os.path.join(path, "manifest.ocdbt"), "rb").read())
    data[0] ^= 0xFF
    bad = tmp_path / "bad"
    os.makedirs(bad)
    for f in os.listdir(path):
        if os.path.isfile(os.path.join(path, f)):
            (bad / f).write_bytes(open(os.path.join(path, f), "rb").read())
    (bad / "manifest.ocdbt").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="bad magic"):
        ckpt.load_checkpoint(str(bad))
    (bad / "_CHECKPOINT_METADATA").write_text('{"item_handlers": "some.OtherHandler"}')
    with pytest.raises(NotImplementedError, match="OtherHandler"):
        ckpt.load_checkpoint(str(bad))
    with pytest.raises(KeyError, match="'x'"):
        ckpt.load_checkpoint(path, {"x": 0})
    Pair = collections.namedtuple("Pair", "w")
    assert np.array_equal(ckpt.load_checkpoint(path, Pair(w=0)).w, np.ones(3, np.float32))
