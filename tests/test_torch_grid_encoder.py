"""Pyramid/triplane encoder of the PyTorch port against the JAX package, on
the CPU.

Tolerances (on the CPU the two agree bit for bit today; the tolerances
allow for another summation order of the f32 corner sums):
* f32 tables: 1e-6 absolute (f32 interpolation, same operation order);
* bf16 tables (the artifact's ``packed_dtype``): both sides round each
  feature to bf16 once per lookup and once per plane-level add, so the
  results may differ by one bf16 rounding step of the feature's magnitude
  if the f32 corner sums land on different sides of a rounding boundary:
  rtol 2**-7 (two bf16 ulps) with a floor of 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatarcraft_tpu.ops import grid_encoder as jge
from avatarcraft_tpu_torch.ops import grid_encoder as ge

SPECS = {
    "small": dict(grid_resolutions=(4, 9), grid_dim=2, plane_resolutions=(17, 33), plane_dim=3),
    "artifact": dict(grid_resolutions=(32, 64, 128), grid_dim=4, plane_resolutions=(512, 1024, 2048), plane_dim=4),
}


def _params(rng, spec_kw, scale=1e-2):
    grids = [rng.normal(size=(r, r, r, spec_kw["grid_dim"])).astype(np.float32) * scale
             for r in spec_kw["grid_resolutions"]]
    planes = [rng.normal(size=(3, r, r, spec_kw["plane_dim"])).astype(np.float32) * scale
              for r in spec_kw["plane_resolutions"]]
    return {"grids": grids, "planes": planes}


def _encode_both(params, spec_kw, x, dtype):
    spec, jspec = ge.PyramidSpec(**spec_kw), jge.PyramidSpec(**spec_kw)
    tparams = {k: [torch.from_numpy(a) for a in v] for k, v in params.items()}
    tdtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    got = ge.pyramid_encode(ge.materialize_packed(tparams, spec, tdtype), torch.from_numpy(x), spec, size=1.6)
    jpacked = jax.tree_util.tree_map(
        lambda t: t.astype(jnp.dtype(dtype)),
        jge.materialize_packed(jax.tree_util.tree_map(jnp.asarray, params), jspec),
    )
    want = jax.jit(lambda p, xx: jge.pyramid_encode(p, xx, jspec, size=1.6))(jpacked, jnp.asarray(x))
    assert got.dtype == tdtype
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


def _points(rng, n):
    x = rng.uniform(-1.7, 1.7, size=(n, 3)).astype(np.float32)  # some outside the bound
    x[:8] = [[-1.6] * 3, [1.6] * 3, [0, 0, 0], [1.6, -1.6, 0], [0.5, 0.5, -1.6], [-2, 0, 2], [0, 1.6, 0], [1e-7, -1e-7, 0]]
    return x


def test_pack_tables_match(rng):
    kw = SPECS["small"]
    params = _params(rng, kw)
    got = ge.materialize_packed({k: [torch.from_numpy(a) for a in v] for k, v in params.items()}, ge.PyramidSpec(**kw))
    want = jge.materialize_packed(jax.tree_util.tree_map(jnp.asarray, params), jge.PyramidSpec(**kw))
    for g, w in zip(got["grids"] + got["planes"], want["grids"] + want["planes"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_output_dim():
    for kw in SPECS.values():
        assert ge.PyramidSpec(**kw).output_dim == jge.PyramidSpec(**kw).output_dim


def test_pyramid_encode_small_f32(rng):
    kw = SPECS["small"]
    x = _points(rng, 512)
    got, want = _encode_both(_params(rng, kw), kw, x, "float32")
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("which,n", [("small", 512), ("artifact", 4096)])
def test_pyramid_encode_bf16(rng, which, n):
    kw = SPECS[which]
    x = _points(rng, n)
    got, want = _encode_both(_params(rng, kw), kw, x, "bfloat16")
    assert got.shape == (n, ge.PyramidSpec(**kw).output_dim)
    np.testing.assert_allclose(got, want, rtol=2**-7, atol=1e-6)
