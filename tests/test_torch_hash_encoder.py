"""The hash-grid encoder of the PyTorch port (K8's plain version) and the
deterministic backward of both encoders' row lookups, against the JAX
package on the CPU (the JAX side under ``jax.jit``).

The spec is 4 levels, log2 size 8, base 4, finest 32: level 0 dense (5^3
rows), levels 1-3 hashed into 256 rows, so both kinds of level occur.

Tolerances:
* level constants, packed dense cells, the deterministic scatter against
  its plain f64 sum rounded to f32, and against itself on the inputs in
  another order: exact;
* features: 2e-5 absolute on a N(0, 1) table. The JAX package disagrees
  with itself at that size: its two layouts differ by up to 6.6e-6 and
  its jit and eager runs by 7.9e-6 (measured), since f32 positions x *
  scale + 0.5 round where XLA may fuse them, and the 8 corner products are
  summed in other orders;
* table gradient: 2e-5 absolute against max|g| 4.5 (the port's from JAX's
  measured at 5.8e-6): f32 sums of the same cotangents in other orders;
* points outside the cube: features and gradient contributions exactly
  zero;
* determinism: two runs of each encoder's backward bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatarcraft_tpu.ops import grid_encoder as jge
from avatarcraft_tpu.ops import hash_encoder as jh
from avatarcraft_tpu_torch.ops import grid_encoder as ge
from avatarcraft_tpu_torch.ops import hash_encoder as th

SPEC_KW = dict(num_levels=4, log2_hashmap_size=8, base_resolution=4, desired_resolution=32)
FEAT_ATOL = 2e-5
GRAD_ATOL = 2e-5
BOUND = 1.6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work (tier-1 runs six
    pytest workers on the machine's cores). Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed=0, n=500, span=1.7):
    rng = np.random.default_rng(seed)
    spec = jh.HashGridSpec(**SPEC_KW)
    table = rng.normal(size=(spec.total_params, 2)).astype(np.float32)
    x = rng.uniform(-span, span, size=(n, 3)).astype(np.float32)
    return table, x


def test_level_constants_match_jax():
    for kw in (SPEC_KW, {}, dict(num_levels=8, base_resolution=8, desired_resolution=None, per_level_scale=1.5)):
        want, got = jh.HashGridSpec(**kw), th.HashGridSpec(**kw)
        assert got.level_constants == want.level_constants
        assert got.total_params == want.total_params and got.output_dim == want.output_dim
        assert got.per_level_scale == want.per_level_scale
    _, _, _, _, use_hash = th.HashGridSpec(**SPEC_KW).level_constants
    assert use_hash == (False, True, True, True)


def test_pack_dense_cells_matches_jax():
    table, _ = _case()
    spec = th.HashGridSpec(**SPEC_KW)
    want = jh.pack_dense_cells(jnp.asarray(table), jh.HashGridSpec(**SPEC_KW))
    got = th.pack_dense_cells(torch.from_numpy(table), spec)
    assert sorted(got) == sorted(want) == [0]
    for lvl in want:
        np.testing.assert_array_equal(got[lvl].numpy(), np.asarray(want[lvl]))


@pytest.mark.parametrize("layout", ["leveled", "flat"])
@pytest.mark.parametrize("packed", [False, True])
def test_hash_encode_matches_jax(layout, packed):
    """Points in and out of the cube ([-1.7, 1.7]^3 against bound 1.6),
    against both JAX layouts; the port's dense cells with and without the
    packed tables."""
    table, x = _case()
    jspec, spec = jh.HashGridSpec(**SPEC_KW), th.HashGridSpec(**SPEC_KW)
    use_cells = packed and layout == "leveled"  # the flat layout reads no packed cells
    want = jax.jit(lambda t, xx: jh.hash_encode(
        t, xx, jspec, size=BOUND, layout=layout,
        packed_cells=jh.pack_dense_cells(t, jspec) if use_cells else None))(table, x)
    t = torch.from_numpy(table)
    got = th.hash_encode(t, torch.from_numpy(x), spec, size=BOUND,
                         packed_cells=th.pack_dense_cells(t, spec) if packed else None)
    assert got.shape == (500, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FEAT_ATOL, rtol=0)
    oob = (np.abs(x) > BOUND).any(-1)
    assert 50 < oob.sum() < 450
    assert (got.numpy()[oob] == 0).all()


@pytest.mark.parametrize("packed", [False, True])
def test_hash_encode_table_gradient_matches_jax(packed):
    table, x = _case(1)
    cot = np.random.default_rng(2).normal(size=(500, 8)).astype(np.float32)
    jspec, spec = jh.HashGridSpec(**SPEC_KW), th.HashGridSpec(**SPEC_KW)

    def jloss(t):
        cells = jh.pack_dense_cells(t, jspec) if packed else None
        return jnp.sum(jh.hash_encode(t, x, jspec, size=BOUND, packed_cells=cells) * cot)

    want = np.asarray(jax.jit(jax.grad(jloss))(table))
    t = torch.from_numpy(table).requires_grad_()
    out = th.hash_encode(t, torch.from_numpy(x), spec, size=BOUND,
                         packed_cells=th.pack_dense_cells(t, spec) if packed else None)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, atol=GRAD_ATOL, rtol=0)
    assert np.abs(want).max() > 1.0


def test_points_outside_the_cube_have_zero_features_and_gradient():
    """Every point outside: the features and the whole table gradient are
    exactly zero, with negative coordinates on every level."""
    rng = np.random.default_rng(3)
    x = rng.uniform(1.7, 4.0, size=(200, 3)).astype(np.float32) * rng.choice([-1.0, 1.0], size=(200, 3)).astype(np.float32)
    table, _ = _case()
    spec = th.HashGridSpec(**SPEC_KW)
    t = torch.from_numpy(table).requires_grad_()
    out = th.hash_encode(t, torch.from_numpy(x), spec, size=BOUND, packed_cells=th.pack_dense_cells(t, spec))
    assert torch.equal(out, torch.zeros_like(out))
    out.sum().backward()
    assert torch.equal(t.grad, torch.zeros_like(t.grad))


def test_init_hash_table():
    spec = th.HashGridSpec(**SPEC_KW)
    t = th.init_hash_table(torch.Generator().manual_seed(0), spec)
    assert t.shape == (spec.total_params, 2) and t.dtype == torch.float32
    assert t.abs().max() <= 1e-4 and t.abs().max() > 0.9e-4
    assert torch.equal(t, th.init_hash_table(torch.Generator().manual_seed(0), spec))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_rows_matches_plain_index_add(dtype):
    """The deterministic backward against index_add in f64: the f32 segment
    sum of f32 values is the f64 sum rounded to f32 wherever the f64 sum
    is exact in f32 (here: values on a 2^-8 grid); the lookup's gradient is
    that sum rounded once to the table's dtype."""
    rng = np.random.default_rng(4)
    idx = torch.from_numpy(rng.integers(0, 37, size=3000))
    grad = torch.from_numpy(np.round(rng.normal(size=(3000, 5)) * 256) / 256).float()
    want = torch.zeros(40, 5, dtype=torch.float64).index_add_(0, idx, grad.double())
    got = ge.scatter_rows(idx, grad, 40)
    assert got.dtype == torch.float32 and torch.equal(got.double(), want)
    # the sums are exact integer sums: no order of the adds changes them
    normal = torch.from_numpy(rng.normal(size=(3000, 5))).float()
    perm = torch.from_numpy(rng.permutation(3000))
    assert torch.equal(ge.scatter_rows(idx, normal, 40), ge.scatter_rows(idx[perm], normal[perm], 40))
    exact = torch.zeros(40, 5, dtype=torch.float64).index_add_(0, idx, normal.double())
    torch.testing.assert_close(ge.scatter_rows(idx, normal, 40).double(), exact, rtol=2**-24, atol=1e-12)
    table = torch.zeros(40, 5, dtype=dtype, requires_grad=True)
    ge.lookup_rows(table, idx).backward(grad.to(dtype))
    want_rounded = torch.zeros(40, 5, dtype=torch.float64).index_add_(0, idx, grad.to(dtype).double())
    assert table.grad.dtype == dtype
    assert torch.equal(table.grad, want_rounded.float().to(dtype))


def _hash_grad(table, x, cot):
    spec = th.HashGridSpec(**SPEC_KW)
    t = torch.from_numpy(table).requires_grad_()
    out = th.hash_encode(t, torch.from_numpy(x), spec, size=BOUND, packed_cells=th.pack_dense_cells(t, spec))
    (out * torch.from_numpy(cot)).sum().backward()
    return t.grad


def _pyramid_grad(params, x, cot, dtype):
    spec = ge.PyramidSpec(grid_resolutions=(4, 9), grid_dim=2, plane_resolutions=(17,), plane_dim=3)
    tp = {k: [torch.from_numpy(a).requires_grad_() for a in v] for k, v in params.items()}
    packed = ge.materialize_packed(tp, spec, dtype)
    out = ge.pyramid_encode(packed, torch.from_numpy(x), spec, size=BOUND)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    return [t.grad for v in tp.values() for t in v]


@pytest.mark.parametrize("encoder", ["hash", "pyramid_f32", "pyramid_bf16"])
def test_encoder_backward_is_deterministic(encoder):
    """Two runs of the backward, bitwise equal (many points per row, so the
    order of the adds matters in f32), and the pyramid's against JAX's at
    the f32 bound of tests/test_torch_grid_encoder.py's inputs."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-BOUND, BOUND, size=(4000, 3)).astype(np.float32)
    if encoder == "hash":
        table, _ = _case()
        cot = rng.normal(size=(4000, 8)).astype(np.float32)
        a, b = _hash_grad(table, x, cot), _hash_grad(table, x, cot)
        assert torch.equal(a, b)
        return
    params = {"grids": [rng.normal(size=(r, r, r, 2)).astype(np.float32) * 1e-2 for r in (4, 9)],
              "planes": [rng.normal(size=(3, 17, 17, 3)).astype(np.float32) * 1e-2]}
    cot = rng.normal(size=(4000, 7)).astype(np.float32)
    dtype = torch.float32 if encoder == "pyramid_f32" else torch.bfloat16
    a, b = _pyramid_grad(params, x, cot, dtype), _pyramid_grad(params, x, cot, dtype)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    if dtype == torch.float32:
        jspec = jge.PyramidSpec(grid_resolutions=(4, 9), grid_dim=2, plane_resolutions=(17,), plane_dim=3)
        want = jax.jit(jax.grad(lambda p: jnp.sum(
            jge.pyramid_encode(jge.materialize_packed(p, jspec), x, jspec, size=BOUND) * cot)))(params)
        for g, w in zip(a, [w for v in want.values() for w in v]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4 * np.abs(np.asarray(w)).max(), rtol=0)
