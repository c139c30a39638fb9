"""The port's orbax writer (``utils/orbax.py::save``, ``write_ocdbt``,
``crc32c``; ``utils/checkpoint.py::save_checkpoint`` and
``save_train_state``) against orbax itself, on the CPU. Each tree of
tests/test_torch_orbax.py's ``TREES`` and the committed toy guidance's,
with port leaves (CPU tensors, bfloat16 tensors, numpy arrays, Python
ints), is written by the port and by the JAX package's
``save_checkpoint``: orbax restores both to the same tree bitwise, without
a target and with one, and the two ``_METADATA`` trees are equal. Also:
the crc32c against the RFC 3720 vector and orbax's own checksums, a flipped
byte refused by both readers, out-of-line values and B-trees of several
levels (read by tensorstore and by orbax), the atomic replace and a
killed save's leftovers, and the writers whose JAX counterparts write orbax (the fast trainer's state as
bake_artifact restores it, save_toy_guidance as the JAX package's
load_toy_guidance reads it).
"""

import functools
import json
import os
import struct

import jax
import numpy as np
import pytest
import torch

from avatarcraft_tpu.models import instant_nsr as jnsr
from avatarcraft_tpu.models import toy_guidance as jtoy
from avatarcraft_tpu.ops.grid_encoder import PyramidSpec as JaxPyramidSpec
from avatarcraft_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from avatarcraft_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from avatarcraft_tpu.workloads import reconstruct as jrecon
from avatarcraft_tpu_torch.models import sd, toy_guidance
from avatarcraft_tpu_torch.utils import checkpoint as ckpt
from avatarcraft_tpu_torch.utils import orbax
from test_torch_orbax import TOY_DIR, TREES, _bits, assert_same_tree


def _toy_tree():
    return jax_load_checkpoint(os.path.join(TOY_DIR, "params"))


WRITE_TREES = {**TREES, "toy": _toy_tree}


def _numpy_tree(tree):
    """The JAX tree with numpy leaves and optax's named tuples as dicts of
    their fields (as ``restore`` gives them back): what the port holds."""
    if hasattr(tree, "_fields"):
        return {f: _numpy_tree(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v) for v in tree)
    if tree is None or isinstance(tree, (bool, int, float)):
        return tree
    return np.asarray(tree)


def _port_leaves(tree):
    """The numpy tree with the port's leaves: float32 arrays as CPU
    tensors, bfloat16 ones as bfloat16 tensors, other arrays (optax's int32
    counts) as numpy, Python scalars as they are."""
    def leaf(a):
        if isinstance(a, np.ndarray) and a.dtype == np.float32:
            return torch.from_numpy(a.copy())
        if isinstance(a, np.ndarray) and a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return a

    if isinstance(tree, dict):
        return {k: _port_leaves(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_port_leaves(v) for v in tree)
    return leaf(tree)


def _metadata(path: str) -> dict:
    with open(os.path.join(path, "_METADATA")) as fp:
        return json.load(fp)


def _sealed_files(root: str, monkeypatch) -> list:
    """The raw bytes of every manifest and node the port's reader reads in
    the store at ``root``."""
    seen = []
    real = orbax._envelope
    monkeypatch.setattr(orbax, "_envelope", lambda raw, magic, what: seen.append(raw) or real(raw, magic, what))
    orbax.read_ocdbt(root)
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("name", sorted(WRITE_TREES))
def test_save_restores_in_orbax_as_orbax_save(tmp_path, name):
    """Orbax restores the port's directory as the JAX package's save of the
    same tree: bitwise, without a target and with one; the same
    ``_METADATA``; the port's reader reads both alike."""
    tree = WRITE_TREES[name]()
    want_dir, got_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_save_checkpoint(want_dir, _numpy_tree(tree))
    ckpt.save_checkpoint(got_dir, _port_leaves(_numpy_tree(tree)))
    assert sorted(os.listdir(got_dir)) == ["_CHECKPOINT_METADATA", "_METADATA", "d", "manifest.ocdbt"]
    want = jax_load_checkpoint(want_dir)
    assert_same_tree(jax_load_checkpoint(got_dir), want)
    assert_same_tree(ckpt.load_checkpoint(got_dir), want)
    meta = _metadata(got_dir)
    assert meta == _metadata(want_dir)
    assert list(meta["tree_metadata"]) == list(_metadata(want_dir)["tree_metadata"])  # JAX's flattening order
    with open(os.path.join(got_dir, "_CHECKPOINT_METADATA")) as fp:
        head = json.load(fp)
    assert head["item_handlers"] == orbax.HANDLER and head["init_timestamp_nsecs"] <= head["commit_timestamp_nsecs"]
    # with a target: its structure (tuples, named tuples), leaves by key path
    like = jax.tree_util.tree_map(np.asarray, tree)
    got_like, want_like = jax_load_checkpoint(got_dir, like), jax_load_checkpoint(want_dir, like)
    assert jax.tree_util.tree_structure(got_like) == jax.tree_util.tree_structure(want_like)
    for g, w in zip(jax.tree_util.tree_leaves(got_like), jax.tree_util.tree_leaves(want_like)):
        assert _bits(g) == _bits(w)


def test_crc32c_matches_the_rfc_vector_and_orbax(tmp_path, monkeypatch):
    """RFC 3720's check value, and the stored checksum of every manifest
    and node of an orbax-written directory (its root store and the
    per-process one) and of the committed toy directory."""
    assert orbax.crc32c(b"123456789") == 0xE3069283
    assert orbax.crc32c(b"") == 0
    path = str(tmp_path / "ts")
    jax_save_checkpoint(path, _numpy_tree(TREES["train_state"]()))
    raws = []
    for root in (path, os.path.join(path, "ocdbt.process_0"), os.path.join(TOY_DIR, "params")):
        raws += _sealed_files(root, monkeypatch)
    assert len(raws) >= 6
    for raw in raws:
        assert orbax.crc32c(raw[:-4]) == struct.unpack("<I", raw[-4:])[0]


@pytest.mark.parametrize("part", ["node", "manifest"])
def test_a_flipped_byte_is_refused(tmp_path, part):
    """A byte flipped in a port-written node or manifest: the port's reader
    refuses it (crc32c) and so does orbax's restore."""
    path = str(tmp_path / "c")
    ckpt.save_checkpoint(path, {"w": torch.arange(6, dtype=torch.float32), "step": 3})
    if part == "node":
        (data,) = os.listdir(os.path.join(path, "d"))  # the node alone: every value is inline
        target = os.path.join(path, "d", data)
    else:
        target = os.path.join(path, "manifest.ocdbt")
    raw = bytearray(open(target, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    with open(target, "wb") as fp:
        fp.write(bytes(raw))
    with pytest.raises(ValueError, match="crc32c"):
        ckpt.load_checkpoint(path)
    with pytest.raises(Exception):
        jax_load_checkpoint(path)


def test_out_of_line_values_and_interior_nodes(tmp_path, monkeypatch):
    """Values over 1024 bytes go to the data file, shorter ones inline; with
    300-byte nodes the store is a B-tree of several levels. Tensorstore
    reads every key of the port's store, the port's reader reads it back,
    and orbax restores a checkpoint written with such nodes and an array
    that zstd's worker threads compressed; an empty store reads as empty
    in both."""
    ts = pytest.importorskip("tensorstore")
    rng = np.random.default_rng(0)
    items = {f"k{i % 5}/{i:04d}": rng.integers(0, 256, int(rng.integers(1, 2500)), dtype=np.uint8).tobytes()
             for i in range(200)}
    root = str(tmp_path / "kv")
    monkeypatch.setattr(orbax, "MAX_DECODED_NODE_BYTES", 300)
    orbax.write_ocdbt(root, items)
    assert orbax.read_ocdbt(root) == items
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}"}).result()
    assert sorted(k.decode() for k in kv.list().result()) == sorted(items)
    for k, v in items.items():
        assert kv.read(k).result().value == v, k
    heights = []
    real = orbax._envelope

    def record(raw, magic, what):
        c = real(raw, magic, what)
        if magic == orbax.NODE_MAGIC:
            heights.append(c.data[0])
        return c

    monkeypatch.setattr(orbax, "_envelope", record)
    orbax.read_ocdbt(root)
    monkeypatch.setattr(orbax, "_envelope", real)
    assert max(heights) >= 2 and heights.count(0) > 10
    n_inline = sum(len(v) <= orbax.MAX_INLINE_VALUE_BYTES for v in items.values())
    (data,) = os.listdir(os.path.join(root, "d"))
    big = sum(len(v) for v in items.values() if len(v) > orbax.MAX_INLINE_VALUE_BYTES)
    assert 0 < n_inline < len(items) and os.path.getsize(os.path.join(root, "d", data)) > big

    big = orbax.ZSTD_THREADED_MIN_BYTES // 4 + 7  # compressed by zstd's worker threads
    tree = {"big": rng.normal(size=(big, 1)).astype(np.float32),
            "many": [{"w": rng.normal(size=(3, 4)).astype(np.float32), "i": int(i)} for i in range(40)]}
    monkeypatch.setattr(orbax, "MAX_DECODED_NODE_BYTES", 2000)
    ckpt.save_checkpoint(str(tmp_path / "tree"), _port_leaves(tree))
    assert_same_tree(jax_load_checkpoint(str(tmp_path / "tree")), tree)
    # an empty store: one version without a root, as tensorstore writes it
    orbax.write_ocdbt(str(tmp_path / "empty"), {})
    assert orbax.read_ocdbt(str(tmp_path / "empty")) == {}
    assert ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/empty"}).result().list().result() == []


def test_save_replaces_and_leaves_nothing_half_written(tmp_path, monkeypatch):
    """A second save replaces the first (as force=True does), a failing one
    leaves the old checkpoint whole and no temporary directory; leaves of
    other types and zero-size arrays are refused, as orbax refuses them;
    a tree without arrays has no store, as orbax writes it."""
    path = str(tmp_path / "c")
    empty = {"d": None, "e": [], "f": {}}
    ckpt.save_checkpoint(path, empty)
    assert sorted(os.listdir(path)) == ["_CHECKPOINT_METADATA", "_METADATA"]
    assert_same_tree(jax_load_checkpoint(path), empty)
    assert_same_tree(ckpt.load_checkpoint(path), empty)
    ckpt.save_checkpoint(path, {"a": np.ones(3, np.float32)})
    want = {"b": 2.5, "c": True, "i": -7, **empty}
    ckpt.save_checkpoint(path, want)
    assert_same_tree(jax_load_checkpoint(path), want)
    assert_same_tree(ckpt.load_checkpoint(path), want)

    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(orbax, "write_ocdbt", broken)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_checkpoint(path, {"a": np.ones(3, np.float32)})
    monkeypatch.undo()
    assert sorted(os.listdir(tmp_path)) == ["c"]
    assert_same_tree(jax_load_checkpoint(path), want)
    with pytest.raises(TypeError, match="str"):
        ckpt.save_checkpoint(str(tmp_path / "s"), {"a": "text"})
    with pytest.raises(ValueError, match="zero size"):
        ckpt.save_checkpoint(str(tmp_path / "z"), {"a": np.zeros((0, 3), np.float32)})
    assert sorted(os.listdir(tmp_path)) == ["c"]


@pytest.mark.parametrize("path_left", [True, False])
def test_save_removes_a_killed_saves_leftovers(tmp_path, monkeypatch, path_left):
    """A save killed before its renames leaves its temporary directory, one
    killed between them leaves the old checkpoint under its ``-old-`` name
    and nothing at the path. The next save of the path writes it whole and
    removes both; the old checkpoint stays until the new one is in place
    (it is removed after the renames, not before)."""
    path = str(tmp_path / "c")
    old = {"a": np.arange(3, dtype=np.float32)}
    ckpt.save_checkpoint(path, old)
    os.makedirs(f"{path}.orbax-checkpoint-tmp-99999/d")
    if path_left:
        ckpt.save_checkpoint(str(tmp_path / "x"), old)
        os.rename(str(tmp_path / "x"), f"{path}.orbax-checkpoint-old-99998")
    else:
        os.rename(path, f"{path}.orbax-checkpoint-old-99998")
    real = orbax.write_ocdbt

    def watched(root, items):  # mid-save: the old checkpoint still on disk
        assert os.path.isdir(path if path_left else f"{path}.orbax-checkpoint-old-99998")
        return real(root, items)

    monkeypatch.setattr(orbax, "write_ocdbt", watched)
    new = {"a": np.arange(5, dtype=np.float32), "b": 3}
    ckpt.save_checkpoint(path, new)
    assert sorted(os.listdir(tmp_path)) == ["c"]
    assert_same_tree(jax_load_checkpoint(path), new)
    assert_same_tree(ckpt.load_checkpoint(path), new)


def _nsr_state():
    """A fast trainer's state in the JAX package's layout: a pyramid field,
    optax Adam's chain after two updates, the 129^3 grid, an int step."""
    fcfg = jnsr.FieldConfig(encoder="tpu_pyramid", pyramid=JaxPyramidSpec(
        grid_resolutions=(4, 8), grid_dim=2, plane_resolutions=(9,), plane_dim=2))
    params = jax.tree_util.tree_map(np.asarray, jnsr.init_field_params(jax.random.PRNGKey(4), fcfg))
    tx = jrecon.make_optimizer(jrecon.ReconstructConfig(), 1000)
    opt_state = tx.init(params)
    rng = np.random.default_rng(4)
    for _ in range(2):
        g = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        _, opt_state = tx.update(g, opt_state, params)
    return params, tx, jax.device_get(opt_state), rng.uniform(0, 100, (129,) * 3).astype(np.float32)


@pytest.mark.parametrize("with_grid", [True, False])
def test_save_train_state_restores_as_bake_artifact_reads_it(tmp_path, with_grid):
    """The port's train state in a directory (the trainers' state_latest)
    restores through JAX's load_checkpoint with bake_artifact's target as
    JAX's own state of it does, bitwise; the 64+64 state (no grid) as JAX's
    save_train_state writes it; a ``.pt`` path keeps the port's file; both
    load back through load_train_state alike."""
    params, tx, opt_state, grid = _nsr_state()
    adam = opt_state[0]
    want_dir, got_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    as_t = functools.partial(ckpt.map_leaves, fn=lambda a: torch.from_numpy(np.array(a)))
    if with_grid:
        jax_save_checkpoint(want_dir, {"params": params, "opt_state": opt_state, "grid": grid, "step": 2})
    else:
        jrecon.save_train_state(want_dir, params, opt_state, 2)
    stats = ckpt.save_train_state(got_dir, as_t(params), as_t(adam.mu), as_t(adam.nu), int(adam.count), 2,
                                  torch.from_numpy(grid) if with_grid else None)
    assert stats["array_bytes"] > 0 and stats["store_bytes"] > 0
    assert _metadata(got_dir) == _metadata(want_dir)
    like = {"params": params, "opt_state": tx.init(params), "step": 0}
    if with_grid:
        like["grid"] = np.zeros((129,) * 3, np.float32)  # tools/bake_artifact.py:62-68
    got, want = jax_load_checkpoint(got_dir, like), jax_load_checkpoint(want_dir, like)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert _bits(g) == _bits(w)
    pt = str(tmp_path / "state.pt")
    assert ckpt.save_train_state(pt, as_t(params), as_t(adam.mu), as_t(adam.nu), int(adam.count), 2,
                                 torch.from_numpy(grid) if with_grid else None) is None
    assert os.path.isfile(pt)
    a, b = ckpt.load_train_state(got_dir, "cpu"), ckpt.load_train_state(pt, "cpu")
    assert (a["count"], a["step"]) == (b["count"], b["step"]) == (2, 2)
    assert (a["grid"] is None) == (b["grid"] is None) == (not with_grid)
    for key in ("params", "mu", "nu"):
        assert all(torch.equal(x, y) for x, y in zip(ckpt.sorted_leaves(a[key]), ckpt.sorted_leaves(b[key])))


def test_save_toy_guidance_reads_in_jax(tmp_path, monkeypatch):
    """A directory the port's save_toy_guidance wrote (the committed toy's
    leaves moved, so no leaf is the target's) reads through the JAX
    package's load_toy_guidance, every leaf bitwise the port's in JAX's
    layout; its params/ metadata is that of the JAX package's save; the
    port reads it back bitwise."""
    params, cfg, embs = toy_guidance.load_toy_guidance(TOY_DIR, device="cpu")
    moved = ckpt.map_leaves(params, lambda t: t + 1.0)
    out = str(tmp_path / "toy")
    toy_guidance.save_toy_guidance(out, moved, cfg, embs)
    committed = jax_load_checkpoint(os.path.join(TOY_DIR, "params"))
    monkeypatch.setattr(jtoy, "init_toy_params", lambda key, jcfg: committed["params"])  # the target, cheaply
    jparams, jcfg = jtoy.load_toy_guidance(out)
    assert jcfg.styles == cfg.styles and jcfg.seed == cfg.seed
    want = jax.tree_util.tree_map(lambda a: np.asarray(a) + np.float32(1.0), committed["params"])
    assert jax.tree_util.tree_structure(jparams) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(want)):
        assert _bits(g) == _bits(w)
    assert _metadata(os.path.join(out, "params")) == _metadata(os.path.join(TOY_DIR, "params"))
    back, _, back_embs = toy_guidance.load_toy_guidance(out, device="cpu")
    assert torch.equal(back_embs, embs)
    assert all(torch.equal(a, b) for a, b in zip(ckpt.sorted_leaves(back), ckpt.sorted_leaves(moved)))
    assert sd.params_from_jax(jparams, "cpu").keys() == back.keys()
