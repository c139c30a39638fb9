"""The ray samplers of the PyTorch port against the JAX package, on the CPU
(the JAX side under ``jax.jit``, as it runs inside the render).

Tolerances:
* linspace(0, 1) and the grid refresh's linspace(-1.6, 1.6, 129): exact,
  the same f32 operations in the same order;
* stratified z values (perturb off): within 1 ulp, since XLA contracts
  near + (far - near) * t into one fused multiply-add where PyTorch rounds
  the product first;
* the up-sampler's quantiles linspace(0.5/n, 1 - 0.5/n, n): within 2 ulp,
  since XLA folds that constant expression itself and rounds some middle
  values differently from its own eager result;
* sample_pdf: equal bin indices (the right-side search and the last-bin
  clamp; one index off would move a whole sample); the inversion of JAX's
  own CDF within 1e-6 absolute; end to end within 2e-5 absolute. XLA sums
  the CDF in another order (its CPU cumsum is a blocked two-level scan), so
  the two CDFs differ by up to 2 ulp, and the inversion divides that by
  the CDF step of the bin (1e-2 and less for these bins of ~0.12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatarcraft_tpu.ops import sampling as jsampling
from avatarcraft_tpu_torch.ops import sampling


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("start,stop,m,ulp", [
    (0.0, 1.0, 64, 0), (-1.6, 1.6, 129, 0), (0.5 / 16, 1 - 0.5 / 16, 16, 2), (0.5 / 64, 1 - 0.5 / 64, 64, 2),
])
def test_linspace_matches_jnp(start, stop, m, ulp):
    want = np.asarray(jax.jit(lambda: jnp.linspace(start, stop, m))())
    got = sampling.linspace(start, stop, m).numpy()
    assert np.abs(got.view(np.int32) - want.view(np.int32)).max() <= ulp


def _near_far(rng, n):
    near = rng.uniform(0.05, 1.0, size=(n, 1)).astype(np.float32)
    far = near + rng.uniform(0.5, 3.0, size=(n, 1)).astype(np.float32)
    return near, far


@pytest.mark.parametrize("num_steps", [6, 64])
def test_stratified_z_vals_matches_jax(rng, num_steps):
    near, far = _near_far(rng, 37)
    want = jax.jit(lambda a, b: jsampling.stratified_z_vals(a, b, num_steps))(near, far)
    got = sampling.stratified_z_vals(_t(near), _t(far), num_steps).numpy()
    assert np.abs(got.view(np.int32) - np.asarray(want).view(np.int32)).max() <= 1


def test_stratified_perturb_stays_in_its_bin(rng):
    near, far = _near_far(rng, 50)
    gen = torch.Generator().manual_seed(3)
    plain = sampling.stratified_z_vals(_t(near), _t(far), 16)
    jit = sampling.stratified_z_vals(_t(near), _t(far), 16, perturb=True, generator=gen)
    half = (_t(far) - _t(near)) / 16 * 0.5
    assert not torch.equal(jit, plain)
    assert ((jit - plain).abs() <= half + 1e-6).all()


@pytest.mark.parametrize("n_samples", [6, 16])
def test_sample_pdf_det_matches_jax(rng, n_samples):
    B, T = 40, 24
    bins = np.sort(rng.uniform(0.1, 3.0, size=(B, T)).astype(np.float32), axis=-1)
    weights = rng.random((B, T - 1)).astype(np.float32) ** 3  # peaked pdfs
    weights[0] = 0.0  # an empty ray: uniform after the 1e-5 floor
    weights[1, :-1] = 0.0  # all mass in the last bin: the clamp at T-1

    def jax_indices(b, w):
        w = w + 1e-5
        cdf = jnp.cumsum(w / jnp.sum(w, -1, keepdims=True), -1)
        cdf = jnp.concatenate([jnp.zeros_like(cdf[:, :1]), cdf], -1)
        u = jnp.broadcast_to(jnp.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples), (B, n_samples))
        inds = jax.vmap(lambda c, uu: jnp.searchsorted(c, uu, side="right"))(cdf, u)
        return jnp.maximum(inds - 1, 0), jnp.minimum(inds, T - 1), cdf, u

    jbelow, jabove, jcdf, ju = jax.jit(jax_indices)(bins, weights)
    cdf = sampling.pdf_cdf(_t(weights))
    u = sampling.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples).expand(B, n_samples)
    below, above = sampling.pdf_bins(cdf, u)
    np.testing.assert_array_equal(below.numpy(), np.asarray(jbelow))
    np.testing.assert_array_equal(above.numpy(), np.asarray(jabove))
    assert (above.numpy()[1] == T - 1).any()

    want = np.asarray(jax.jit(lambda b, w: jsampling.sample_pdf(b, w, n_samples, det=True))(bins, weights))
    inverted = sampling.invert_cdf(_t(bins), _t(jcdf), _t(ju))
    np.testing.assert_allclose(inverted.numpy(), want, atol=1e-6, rtol=0)
    got = sampling.sample_pdf(_t(bins), _t(weights), n_samples, det=True)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_sample_pdf_random_draws_inside_the_bins(rng):
    B, T = 30, 12
    bins = np.sort(rng.uniform(0.1, 3.0, size=(B, T)).astype(np.float32), axis=-1)
    weights = rng.random((B, T - 1)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    got = sampling.sample_pdf(_t(bins), _t(weights), 8, det=False, generator=gen)
    assert got.shape == (B, 8)
    assert (got >= _t(bins[:, :1]) - 1e-6).all() and (got <= _t(bins[:, -1:]) + 1e-6).all()
