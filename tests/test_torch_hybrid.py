"""The hybrid render of the PyTorch port (``workloads/hybrid.py``: an
avatar over a background NeRF, merged by depth) against the JAX package's
workloads/hybrid.py, on the CPU, with and without a warp, and with several
avatars. The avatar is tests/test_torch_render_parity.py's small field with
a closed surface; the warped one is posed by a rigid transform of an
icosphere around it (every face carries the same transform, so the warp
has no face ties); the background is a narrow NeRF drawn by the port and
carried to JAX. The JAX side runs under ``jax.jit``.

Tolerances: rgb and depth 1e-4 (tighter than tests/test_torch_parity_render.py's
2e-3 frame tolerance; measured 7.2e-6 on rgb), the masks exactly, on every
pixel whose avatar and background depths are not within 1e-3 of each other
(the composite's choice of such a pixel follows the last bits of both
depths).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from avatarcraft_tpu.models import instant_nsr as jnsr
from avatarcraft_tpu.models import nerf as jnerf
from avatarcraft_tpu.warp import WarpData as JaxWarpData
from avatarcraft_tpu.workloads import hybrid as jhybrid
from avatarcraft_tpu_torch.models import instant_nsr as nsr
from avatarcraft_tpu_torch.models import nerf
from avatarcraft_tpu_torch.utils.checkpoint import map_leaves
from avatarcraft_tpu_torch.warp import WarpData
from avatarcraft_tpu_torch.workloads import hybrid
from test_torch_render import SMALL_JAX_FCFG
from test_torch_render_parity import _surface_field
from test_warp import icosphere

FRAME_ATOL = 1e-4
TIE = 1e-3
RCFG_KW = dict(num_steps=8, upsample_steps=8, upsample_round=4, perturb=False)
NERF_KW = dict(depth=2, width=16, skip_layer=1, multires=4, multires_view=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: tier-1 runs six
    pytest workers on the machine's cores. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def scene():
    """(JAX avatar params, port avatar params, port field config, rays)."""
    jparams, params, fcfg = _surface_field()
    rng = np.random.default_rng(0)
    ro = np.tile(np.asarray([[0.2, 0.1, -3.0]], np.float32), (48, 1))
    target = rng.uniform(-0.9, 0.9, size=(48, 3)).astype(np.float32) + np.asarray([0.2, 0.1, 0.0], np.float32)
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return jparams, params, fcfg, ro, rd


def _background(sigma_bias: float):
    cfg = nerf.NeRFConfig(**NERF_KW)
    params = nerf.init_nerf_params(torch.Generator().manual_seed(4), cfg)
    params["sigma"]["b"] += sigma_bias
    return params, cfg, map_leaves(params, lambda t: t.numpy()), jnerf.NeRFConfig(**NERF_KW)


@functools.cache
def _posed_body(shift: tuple):
    """An icosphere of radius 0.9 (the avatar's surface), rotated and moved
    by ``shift``: (port WarpData, JAX WarpData)."""
    verts, faces = icosphere(3)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rotation.from_rotvec([0.3, -0.2, 0.1]).as_matrix()
    T[:3, 3] = shift
    posed = (verts * 0.9) @ T[:3, :3].T + T[:3, 3]
    Ts = np.broadcast_to(T, (len(verts), 4, 4))
    return WarpData.create(posed, faces, Ts, device="cpu"), JaxWarpData.create(posed, faces, Ts)


BODY_SHIFT = (0.25, 0.1, 0.2)


@functools.cache
def _jax_hybrid(warped: bool):
    """JAX's render_hybrid_avatar at RCFG_KW, jitted once for the module
    (the warp data of BODY_SHIFT as its constants)."""
    jwd = _posed_body(BODY_SHIFT)[1] if warped else None
    rcfg, bcfg = jnsr.RenderConfig(**RCFG_KW), jnerf.NeRFConfig(**NERF_KW)
    return jax.jit(lambda p, b, o, d: jhybrid.render_hybrid_avatar(
        p, SMALL_JAX_FCFG, rcfg, b, bcfg, o, d, warp_data=jwd, key=jax.random.PRNGKey(0)))


def _clear(t_a, t_b):
    """The pixels whose two depths are not a tie (both finite and within
    TIE of each other)."""
    both = np.isfinite(t_a) & np.isfinite(t_b)
    gap = np.subtract(t_a, t_b, out=np.zeros(t_a.shape), where=both)
    return ~(both & (np.abs(gap) <= TIE))


def _compare(got, want, t_a, t_b):
    """rgb and depth within FRAME_ATOL off the depth ties."""
    clear = _clear(t_a, t_b)
    assert clear.mean() > 0.9
    np.testing.assert_allclose(got["rgb"].numpy()[clear], np.asarray(want["rgb"])[clear], atol=FRAME_ATOL, rtol=0)
    gd, wd = got["depth"].numpy()[clear], np.asarray(want["depth"])[clear]
    assert np.array_equal(np.isinf(gd), np.isinf(wd))
    np.testing.assert_allclose(gd[np.isfinite(gd)], wd[np.isfinite(wd)], atol=FRAME_ATOL, rtol=0)


@pytest.mark.parametrize("warped,sigma_bias", [(False, 0.0), (True, 0.0), (True, -100.0)])
def test_render_hybrid_avatar_matches_jax(scene, warped, sigma_bias):
    """With and without the warp, over a background that fills some rays
    and over an empty one (sigma <= 0: acc 0, depth +inf)."""
    jparams, params, fcfg, ro, rd = scene
    bkg, bcfg, jbkg, jbcfg = _background(sigma_bias)
    rcfg, jrcfg = nsr.RenderConfig(**RCFG_KW), jnsr.RenderConfig(**RCFG_KW)
    wd = _posed_body(BODY_SHIFT)[0] if warped else None
    got = hybrid.render_hybrid_avatar(params, fcfg, rcfg, bkg, bcfg, _t(ro), _t(rd), warp_data=wd)
    want = _jax_hybrid(warped)(jparams, jbkg, ro, rd)
    mask = got["avatar_mask"].numpy()
    assert 0.15 < mask.mean() < 0.95  # some rays hit the avatar, some miss it
    bk = nerf.render_nerf_rays(bkg, _t(ro), _t(rd), bcfg, near=0.5, far=6.0)
    t_b = np.where(bk["acc"].numpy() > 0.05, bk["depth"].numpy(), np.inf)
    t_a = np.where(mask, got["depth"].numpy(), np.inf)
    if sigma_bias < 0:
        assert np.isinf(t_b).all()
    else:  # the background fills some rays; the avatar wins some pixels and the background shows in others
        assert np.isfinite(t_b).any() and np.isinf(t_b).any()
        assert (t_a < t_b).any() and (np.isfinite(t_b) & (t_b < t_a)).any()
    clear = _clear(t_a, t_b)
    assert np.array_equal(mask[clear], np.asarray(want["avatar_mask"])[clear])
    _compare(got, want, t_a, t_b)


def test_render_hybrid_multi_persons_matches_jax(scene):
    """Two warped avatars and an unwarped one over one background, the
    nearest surface winning, every pixel held (these rays have no depth
    ties); each avatar renders with its own stream (avatar_generator(seed,
    i)), distinct from the others'."""
    jparams, params, fcfg, ro, rd = scene
    bkg, bcfg, jbkg, jbcfg = _background(0.0)
    rcfg, jrcfg = nsr.RenderConfig(**RCFG_KW), jnsr.RenderConfig(**RCFG_KW)
    (wa, ja), (wb, jb) = _posed_body((0.6, 0.0, 0.4)), _posed_body((-0.5, 0.2, -0.3))
    avatars = [dict(params=params, fcfg=fcfg, rcfg=rcfg, warp_data=w) for w in (wa, wb, None)]
    got = hybrid.render_hybrid_multi_persons(avatars, bkg, bcfg, _t(ro), _t(rd), seed=0)
    javatars = [dict(params=jparams, fcfg=SMALL_JAX_FCFG, rcfg=jrcfg, warp_data=w) for w in (ja, jb, None)]
    want = jax.jit(lambda p, b, o, d: jhybrid.render_hybrid_multi_persons(
        [{**a, "params": p} for a in javatars], b, jbcfg, o, d, key=jax.random.PRNGKey(0)))(jparams, jbkg, ro, rd)
    bk = nerf.render_nerf_rays(bkg, _t(ro), _t(rd), bcfg, near=0.5, far=6.0)
    t_b = np.where(bk["acc"].numpy() > 0.05, bk["depth"].numpy(), np.inf)
    t_a = got["depth"].numpy()
    assert (t_a < t_b).any()  # the avatars win some pixels
    # no depth ties on these rays: every pixel is held
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]), atol=FRAME_ATOL, rtol=0)
    np.testing.assert_allclose(t_a, np.asarray(want["depth"]), atol=FRAME_ATOL, rtol=0)
    draws = [torch.rand(4, generator=hybrid.avatar_generator(s, i, "cpu")) for s, i in ((0, 0), (0, 1), (1, 0))]
    assert not torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    assert torch.equal(draws[0], torch.rand(4, generator=hybrid.avatar_generator(0, 0, "cpu")))


def test_composite_by_depth():
    a, b = torch.zeros(4, 3), torch.ones(4, 3)
    da, db = torch.tensor([1.0, 2.0, torch.inf, 3.0]), torch.tensor([2.0, 1.0, torch.inf, 3.0])
    got = hybrid.composite_by_depth(a, b, da, db)
    want = jhybrid.composite_by_depth(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), jnp.asarray(da.numpy()),
                                      jnp.asarray(db.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[:, 0].tolist() == [0.0, 1.0, 1.0, 1.0]


def test_hybrid_takes_the_avatar_whole():
    """The avatar's tree goes to render_rays as it is: the same frame as
    render_rays of the same tree, the depth un-normalised with the cube
    bounds when there is no warp."""
    jparams, params, fcfg = _surface_field()
    bkg, bcfg, _, _ = _background(-100.0)
    rcfg = nsr.RenderConfig(**RCFG_KW)
    ro = np.tile(np.asarray([[0.0, 0.0, -3.0]], np.float32), (2, 1))
    rd = np.asarray([[0, 0, 1.0], [0.6, 0, 0.8]], np.float32)
    out = hybrid.render_hybrid_avatar(params, fcfg, rcfg, bkg, bcfg, _t(ro), _t(rd))
    ref = nsr.render_rays(params, _t(ro), _t(rd), fcfg, rcfg, 0.0)
    near, far = nsr.near_far_from_bound(_t(ro), _t(rd), rcfg.bound)
    t = ref["depth"][:, None] * (far - near) + near
    assert out["avatar_mask"].tolist() == [True, False]
    assert torch.equal(out["rgb"][0], ref["rgb"][0]) and float(out["depth"][0]) == float(t[0, 0])
    assert torch.isinf(out["depth"][1])
