"""Near/far, bit-packed occupancy, sample selection, compaction and floater
pruning (flood fill, prune, pool) of the PyTorch port against the JAX
package, on the CPU.

Tolerance: none. These functions are integer logic on f32 inputs computed
with the same f32 operations in the same order, so every output is
bit-exact (the packed table is compared as uint32 words). The JAX side runs
under ``jax.jit``, as it does inside the render (XLA then turns a division by
a constant into a multiplication by its reciprocal, which the port copies).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatarcraft_tpu.ops import occupancy as jocc
from avatarcraft_tpu.ops.sampling import near_far_from_bound as jax_near_far
from avatarcraft_tpu_torch.ops import occupancy as occ
from avatarcraft_tpu_torch.ops.sampling import near_far_from_bound


def _t(a):
    return torch.as_tensor(np.array(a))


def _grid(rng, R, frac_occupied):
    g = rng.uniform(0.0, 1.0, size=(R, R, R)).astype(np.float32)
    return np.where(g < frac_occupied, 50.0 * g + 20.0, g).astype(np.float32)


def _rays(rng, n):
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    o += np.asarray([0.0, 0.0, -2.5], np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32) * 0.3 + np.asarray([0, 0, 1], np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[0] = [0.0, 0.0, 1.0]  # axis-parallel: exercises the rd + 1e-15 guard
    return o, d.astype(np.float32)


def test_near_far_bit_exact(rng):
    o, d = _rays(rng, 257)
    o[1] = [0.0, 0.0, 0.0]  # inside the cube: near clamps to 0.05
    near, far = near_far_from_bound(_t(o), _t(d), 1.6)
    jn, jf = jax.jit(jax_near_far, static_argnums=(2,))(jnp.asarray(o), jnp.asarray(d), 1.6)
    np.testing.assert_array_equal(near.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(far.numpy(), np.asarray(jf))
    assert float(near[1, 0]) == np.float32(0.05)


@pytest.mark.parametrize("R", [33, 40, 129])
def test_pack_occupancy_bits_bit_exact(rng, R):
    g = _grid(rng, R, 0.3)
    thresh = np.float32(min(10.0, g.mean()))
    got = occ.pack_occupancy_bits(_t(g), torch.tensor(thresh))
    want = np.asarray(jax.jit(jocc.pack_occupancy_bits)(jnp.asarray(g), thresh))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_occupancy_lookup_bits_bit_exact(rng):
    R = 65
    g = _grid(rng, R, 0.4)
    packed = np.asarray(jocc.pack_occupancy_bits(jnp.asarray(g), 10.0))
    # points on and around cell centres and half-cells, plus out-of-bound ones
    pts = rng.uniform(-1.8, 1.8, size=(64, 50, 3)).astype(np.float32)
    pts[0] = (np.round(rng.uniform(0, 2 * (R - 1), size=(50, 3))) / 2 / (R - 1) * 3.2 - 1.6)
    got = occ.occupancy_lookup_bits(_t(packed.view(np.int32)), R, _t(pts), 1.6)
    lookup = jax.jit(jocc.occupancy_lookup_bits, static_argnums=(1, 3))
    want = np.asarray(lookup(jnp.asarray(packed), R, jnp.asarray(pts), 1.6))
    np.testing.assert_array_equal(got.numpy(), want)
    # and the same as looking the grid itself up
    dense_lookup = jax.jit(jocc.occupancy_lookup, static_argnums=(2,))
    dense = np.asarray(dense_lookup(jnp.asarray(g), jnp.asarray(pts), 1.6)) > 10.0
    np.testing.assert_array_equal(got.numpy(), dense)


@pytest.mark.parametrize("k", [4, 24, 32])
def test_select_occupied_samples_bit_exact(rng, k):
    N, M = 300, 96
    z = np.sort(rng.uniform(0.05, 4.0, size=(N, M)).astype(np.float32), axis=1)
    dens = np.zeros((N, M), np.float32)
    for r in range(N):  # n_occ from 0 through M: below, at and above k
        n_occ = r % (M + 1) if r < 2 * (M + 1) else rng.integers(0, M + 1)
        dens[r, rng.choice(M, size=n_occ, replace=False)] = 1.0
    z_sel, valid = occ.select_occupied_samples(_t(z), _t(dens > 0.5), k, 0.5)
    select = jax.jit(jocc.select_occupied_samples, static_argnums=(2,))
    jz, jv = select(jnp.asarray(z), jnp.asarray(dens > 0.5), k, 0.5)
    np.testing.assert_array_equal(z_sel.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    # densities compared with the threshold give the same selection
    z2, v2 = occ.select_occupied_samples(_t(z), _t(dens), k, 0.5)
    np.testing.assert_array_equal(z2.numpy(), z_sel.numpy())
    np.testing.assert_array_equal(v2.numpy(), valid.numpy())


@pytest.mark.parametrize("budget", [1, 100, 397, 2000])
def test_compact_and_scatter_bit_exact(rng, budget):
    """budget below, at and above the valid count: overflow is dropped in
    flat order, unused slots point at 0 and scatter back as zeros."""
    T = 1000
    valid = rng.random(T) < 0.397
    sel, kept = occ.compact_indices(_t(valid), budget)
    jsel, jkept = jax.jit(jocc.compact_indices, static_argnums=(1,))(jnp.asarray(valid), budget)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jkept))
    assert int(kept.sum()) == min(budget, int(valid.sum()))

    vals = rng.normal(size=(budget, 3)).astype(np.float32)
    n_kept = int(kept.sum())
    got = occ.scatter_to_flat(_t(vals), sel, T, torch.tensor(n_kept))
    scatter = jax.jit(jocc.scatter_to_flat, static_argnums=(2,))
    want = scatter(jnp.asarray(vals), jsel, T, jnp.asarray(n_kept))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _blobby_grid(rng, R=24, n_blobs=6):
    """Densities: a few random boxes at 100 over a 0..1 floor, in the
    first R-6 cells of each axis, and one isolated 2^3 box in the far
    corner."""
    g = rng.random((R, R, R)).astype(np.float32)
    for _ in range(n_blobs):
        lo = rng.integers(0, R - 10, 3)
        hi = lo + rng.integers(1, 5, 3)
        g[lo[0] : hi[0], lo[1] : hi[1], lo[2] : hi[2]] = 100.0
    g[-3:-1, -3:-1, -3:-1] = 100.0
    return g


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prune_grid_floaters_matches_jax(seed):
    rng = np.random.default_rng(seed)
    grid = _blobby_grid(rng)
    prev = np.where(rng.random(grid.shape) < 0.02, 100.0, 0.0).astype(np.float32)
    prev[:12] = np.where(grid[:12] > 50, 100.0, 0.0)  # the blobs near the origin are seeded
    prev[-6:] = 0.0  # the corner box floats
    want = np.asarray(jax.jit(jocc.prune_grid_floaters)(grid, prev))
    got = occ.prune_grid_floaters(_t(grid), _t(prev))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[-3:-1, -3:-1, -3:-1] == 0).all() and (want > 50).any()  # the floater pruned, the seeded kept


def test_prune_grid_floaters_empty_seed_matches_jax():
    """No occupied cell of the new grid was occupied before: every
    occupied cell is kept (the floor below the threshold is zeroed)."""
    grid = _blobby_grid(np.random.default_rng(5))
    prev = np.zeros_like(grid)
    prev[0, 0, 0] = 100.0 if grid[0, 0, 0] < 50 else 0.0
    want = np.asarray(jax.jit(jocc.prune_grid_floaters)(grid, prev))
    got = occ.prune_grid_floaters(_t(grid), _t(prev))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[grid > 50], grid[grid > 50])
    assert (want[grid < 1.0] == 0).all()


@pytest.mark.parametrize("max_iters,check_every", [(None, 8), (None, 1), (None, 7), (7, 8), (7, 3), (0, 8)])
def test_flood_fill_matches_jax(max_iters, check_every):
    """A serpentine corridor longer than the default 3R sweeps (so the
    default fill is cut too) beside a random component, filled from one end
    to convergence or a cut at several convergence-check periods; and an
    empty seed."""
    R = 20
    m = np.zeros((R, R, R), bool)
    for x in range(R):
        if x % 2 == 0:
            m[x, :, 5] = True
        else:
            m[x, R - 1 if (x // 2) % 2 == 0 else 0, 5] = True
    m[:, :, 12] = np.random.default_rng(0).random((R, R)) < 0.5
    seed = np.zeros_like(m)
    seed[0, 0, 5] = True
    seed[3, 3, 12] = True
    for s in (seed, np.zeros_like(m)):
        want = np.asarray(jocc.flood_fill_occupancy(jnp.asarray(m), jnp.asarray(s), max_iters))
        got = occ.flood_fill_occupancy(_t(m), _t(s), max_iters, check_every=check_every)
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.sum() > (2 if s.any() and max_iters != 0 else -1)
    assert want.sum() == 0


@pytest.mark.parametrize("R,factor", [(17, 2), (16, 2), (13, 3)])
def test_pool_grid_matches_jax(R, factor):
    g = np.random.default_rng(R).random((R, R, R)).astype(np.float32) * 100
    want = np.asarray(jocc.pool_grid(jnp.asarray(g), factor))
    got = occ.pool_grid(_t(g), factor)
    np.testing.assert_array_equal(got.numpy(), want)
